"""Device ms of the image branch a batch (CUDA events around
``model.image_branch``), mean over the traced run's window."""


def read(o):
    return sum(o.image_branch_ms) / len(o.image_branch_ms) if o.image_branch_ms else None
