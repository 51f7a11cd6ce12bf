"""Models of the port: the SGPN eval forward and its parts."""

from or4d_tpu_torch.models.sgpn import SGPN, SGPNOutputs

__all__ = ["SGPN", "SGPNOutputs"]
