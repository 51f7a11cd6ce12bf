"""Start D ranks on one machine, the counterpart of JAX's virtual devices.

:func:`spawn` runs ``fn(*args)`` in ``world_size`` processes started with
``torch.multiprocessing``'s spawn method, each rank in a process group on a
free ``localhost`` port (``gloo`` on the CPU; ``nccl`` or ``gloo`` on the
card: NCCL takes one rank a GPU, gloo several ranks on one), and returns
every rank's result, rank order. :func:`trainer_jobs` is a worker for it:
``Trainer`` steps, eval and serving on the mesh a config names, as the
tests and ``chip_smoke.py`` drive them. Workers live here, in the port, so a
spawned child imports nothing of the tests (whose conftest imports JAX).

Under ``torchrun`` a process group is started by the launcher instead and
the CLI builds the mesh (``python -m or4d_tpu_torch.cli``).
"""

from __future__ import annotations

import os
import socket
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist


def free_port() -> int:
    """A TCP port on localhost that nothing listens on now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, fn, world_size, port, backend, device, threads, out_dir, args):
    torch.set_num_threads(threads)
    kw = {}
    if device == "cuda":
        card = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(card)
        if backend == "nccl":
            kw["device_id"] = card
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world_size, rank=rank, **kw)
    try:
        result = fn(*args)
        dist.barrier()
    finally:
        dist.destroy_process_group()
    torch.save(result, Path(out_dir) / f"rank{rank}.pt")


def spawn(fn, world_size: int, args: tuple = (), backend: str = "gloo", device: str = "cpu",
          threads: int | None = None, timeout: float = 900.0) -> list:
    """``fn(*args)`` on ranks 0..world_size-1 (``fn`` importable by name,
    its result picklable); returns the results in rank order. ``device``
    "cuda" puts rank r on card r % device_count. A rank that raises raises
    here (torch's ``ProcessRaisedException``, with its traceback); past
    ``timeout`` seconds every rank is killed and TimeoutError raised."""
    threads = threads or max(1, (os.cpu_count() or 1) // world_size)
    with tempfile.TemporaryDirectory(prefix="or4d_ranks_") as out_dir:
        ctx = torch.multiprocessing.start_processes(
            _rank_main, args=(fn, world_size, free_port(), backend, device, threads, out_dir, args),
            nprocs=world_size, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=1.0):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world_size} ranks of {fn.__name__} still running after {timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(Path(out_dir) / f"rank{r}.pt", map_location="cpu", weights_only=False)
                for r in range(world_size)]


def _cpu(x):
    """Tensors of a (nested) result moved to the CPU."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    if isinstance(x, dict):
        return {k: _cpu(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_cpu(v) for v in x)
    return x


def trainer_jobs(jobs: list[dict], device: str = "cpu") -> list[dict]:
    """A worker for :func:`spawn`: per job, a ``Trainer`` of ``job["cfg"]``
    (``job["weights"]`` the class weights; its parameters ``job["state"]``
    when given, else made from ``job.get("seed", 0)``) on the mesh the
    config names (``job["plain"]``: on no mesh, as one process without a
    group runs), then, in order:

    * ``train``: a list of {"batch", "seed", "draws", "keep"} steps (the
      generator seeded with "seed"; draws and keep for the global batch,
      optional) -> ``parts`` (each step's losses), ``launches`` (the
      kernel launch counters over those steps), ``grads`` (the last
      step's summed gradients, by name), ``state`` (the state_dict after)
      and ``rel_logprobs`` (the last step's, gathered);
    * ``eval``: a list of batches -> ``eval`` [(rel, obj)], gathered, and
      ``eval_launches``;
    * ``serving``: a list of batches -> ``f1``, a ``ServingEvaluator``'s
      (the caches built and one evaluation), and ``serving_launches``;
      ``refusal``: its ValueError's message, None if it built;
    * ``trace``: a directory: one more step of ``train``'s first batch
      under ``utils.profiling.trace`` -> ``trace`` (the file);
    * ``time``: n -> ``step_ms``, n more such steps, each synchronised.

    Every result is on the CPU."""
    from or4d_tpu_torch.data.vocab import DEFAULT_VOCAB
    from or4d_tpu_torch.ops import launch_counts, reset_launch_counts
    from or4d_tpu_torch.parallel.mesh import Mesh
    from or4d_tpu_torch.train.loop import Trainer

    results = []
    for job in jobs:
        tr = Trainer(job["cfg"], DEFAULT_VOCAB, *job["weights"], device=device, seed=job.get("seed", 0),
                     mesh=Mesh() if job.get("plain") else None)
        if job.get("state") is not None:
            tr.model.load_state_dict(job["state"])
        res = {"mesh": tr.mesh.shape}

        def step(s):
            g = torch.Generator().manual_seed(s.get("seed", 0))
            return tr.train_step(s["batch"], g, augment_draws=s.get("draws"), dropout_keep=s.get("keep"))

        if job.get("train"):
            reset_launch_counts()
            res["parts"] = [{k: float(v) for k, v in step(s).items()} for s in job["train"]]
            res["launches"] = launch_counts()
            res["grads"] = {n: p.grad.clone() for n, p in tr.model.named_parameters() if p.grad is not None}
            res["state"] = {k: v.clone() for k, v in tr.model.state_dict().items()}
            res["rel_logprobs"] = tr.last_rel_logprobs
        if job.get("eval"):
            reset_launch_counts()
            res["eval"] = [tr.eval_step(b) for b in job["eval"]]
            res["eval_launches"] = launch_counts()
        if job.get("serving"):
            from or4d_tpu_torch.serving import ServingEvaluator

            reset_launch_counts()
            res["f1"] = ServingEvaluator(tr, job["serving"]).evaluate()
            res["serving_launches"] = launch_counts()
        if "refusal" in job:
            from or4d_tpu_torch.serving import ServingEvaluator

            try:
                ServingEvaluator(tr, job["refusal"])
                res["refusal"] = None
            except ValueError as e:
                res["refusal"] = str(e)
        if job.get("trace"):
            from or4d_tpu_torch.utils.profiling import trace

            with trace(job["trace"]) as path:
                step(job["train"][0])
            res["trace"] = str(path)
        if job.get("time"):
            res["step_ms"] = []
            for _ in range(job["time"]):
                if device == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                step(job["train"][0])
                if device == "cuda":
                    torch.cuda.synchronize()
                res["step_ms"].append(1e3 * (time.perf_counter() - t0))
        results.append(_cpu(res))
        del tr
    return results
