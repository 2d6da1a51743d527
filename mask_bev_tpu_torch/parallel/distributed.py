"""Data parallelism over ``torch.distributed``: one process a device.

Port of ``mask_bev_tpu/parallel/mesh.py``. The JAX package writes its
training step against the global batch and lets jit shard it over a mesh,
so a sharded step equals the single-device step on the same global batch.
Here each process (a rank) holds rows ``[r B/N, (r+1) B/N)`` of the global
batch of ``cfg.batch_size`` rows and runs the step on them; every place
where the single-device step crosses samples crosses ranks instead:

* the loss normalisers (the GT mask count, the class-weight sum) are summed
  over the ranks, so each rank's loss is its part of the global loss
  (``losses.py``);
* the training encoder's masked batch norm takes its count, mean and
  variance over the kept rows of the whole batch, through a differentiable
  all-reduce (:func:`all_reduce_sum`; ``models/encoder.py``);
* the random draws of a global batch's tensor are drawn whole from the
  shared generator on every rank, which keeps its own rows
  (:func:`rand_rows`), so they do not depend on the world size;
* the gradients are summed over the ranks (:func:`all_reduce_grads`: a few
  flat buckets, one ``all_reduce`` each; a sum, not a mean) before the
  optimizer, whose clipping norm then sees the global gradient.

Every function is a no-op without a process group, so the one-process path
is the single-device step bit for bit. Under a process group of one rank
(NCCL's reduce is then an identity) every collective runs and changes
nothing.

Start-up (:func:`init_from_env`), the first of these that is set:

* ``MASKBEV_COORDINATOR`` (host:port of rank 0), ``MASKBEV_NUM_PROCESSES``
  and ``MASKBEV_PROCESS_ID``, the JAX package's contract;
* ``torchrun``'s ``WORLD_SIZE``, ``RANK`` and ``MASTER_ADDR``/
  ``MASTER_PORT``;
* SLURM's ``SLURM_NTASKS`` and ``SLURM_PROCID``, with
  ``MASKBEV_COORDINATOR`` naming task 0.

A rank's card is ``cuda:LOCAL_RANK`` (``torchrun``), ``cuda:SLURM_LOCALID``
or ``cuda:rank``, modulo the cards the process sees (a SLURM task bound to
one card sees it as ``cuda:0``); the backend is NCCL on the card and gloo
on the CPU (:func:`device`).
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# gradient bucket size for the all-reduce: a few buckets for the flagship
# model's 192 M f32 parameters
BUCKET_BYTES = 128 * 2 ** 20


def active() -> bool:
    """True under an initialised process group (of any size)."""
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if active() else 0


def world_size() -> int:
    return dist.get_world_size() if active() else 1


def local_rank(rank_: Optional[int] = None) -> int:
    """This process's card: its index among the ranks of its host
    (``LOCAL_RANK``, ``SLURM_LOCALID``, else the rank) modulo the cards it
    sees. A task that SLURM binds to one card (``--gpus-per-task=1``)
    sees that card alone, as ``cuda:0``."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    for var in ("LOCAL_RANK", "SLURM_LOCALID"):
        if os.environ.get(var) is not None:
            i = int(os.environ[var])
            return i % n if n else i
    r = rank() if rank_ is None else rank_
    return r % n if n else 0


def device(requested="cuda") -> torch.device:
    """The rank's device: ``cuda`` means the rank's card under a process
    group, the current card without one; anything else as given."""
    dev = torch.device(requested)
    if dev.type == "cuda" and dev.index is None and active():
        dev = torch.device("cuda", local_rank())
    return dev


def init(coordinator: str, num_processes: int, process_id: int,
         device_type: str = "cuda", backend: Optional[str] = None) -> None:
    """Join the process group of ``num_processes`` ranks whose rank 0
    listens at ``coordinator`` (host:port); NCCL for ``cuda``, gloo for
    the CPU, unless ``backend`` says otherwise."""
    if backend is None:
        backend = "nccl" if device_type == "cuda" else "gloo"
    if backend == "nccl":
        torch.cuda.set_device(local_rank(int(process_id)))
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))


def init_from_env(device_type: str = "cuda",
                  backend: Optional[str] = None) -> bool:
    """Join the process group the environment describes (see the module
    docstring); True when one of more than one rank was joined. Without
    such variables, or with one process, nothing happens."""
    if active():
        return world_size() > 1
    env = os.environ
    if env.get("MASKBEV_NUM_PROCESSES"):
        n = int(env["MASKBEV_NUM_PROCESSES"])
        pid, coord = env.get("MASKBEV_PROCESS_ID"), env.get(
            "MASKBEV_COORDINATOR")
    elif env.get("WORLD_SIZE"):
        n = int(env["WORLD_SIZE"])
        pid = env.get("RANK")
        coord = (f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
                 if env.get("MASTER_ADDR") and env.get("MASTER_PORT")
                 else None)
    elif env.get("SLURM_NTASKS"):
        n = int(env["SLURM_NTASKS"])
        pid, coord = env.get("SLURM_PROCID"), env.get("MASKBEV_COORDINATOR")
    else:
        return False
    if n <= 1:
        return False
    if pid is None or coord is None:
        raise ValueError(
            f"{n} processes but no rank or coordinator in the environment: "
            f"set MASKBEV_PROCESS_ID and MASKBEV_COORDINATOR (host:port of "
            f"rank 0), or launch with torchrun")
    init(coord, n, int(pid), torch.device(device_type).type, backend)
    return True


def shutdown() -> None:
    if active():
        dist.destroy_process_group()


def barrier() -> None:
    if active():
        dist.barrier()


def divisibility_error(n_rows: int, key: str, world: int) -> ValueError:
    return ValueError(
        f"batch leading dim {n_rows} of '{key}' is not divisible by the "
        f"{world}-rank process group; set batch_size to a multiple of the "
        f"world size (or run fewer processes)")


def shard_batch(batch: Dict, rank_: Optional[int] = None,
                world: Optional[int] = None) -> Dict:
    """The rank's rows of a global batch (numpy arrays or tensors): rows
    ``[r B/N, (r+1) B/N)`` of every array with a leading dimension.
    Raises where ``B`` is not a multiple of ``N``."""
    n = world_size() if world is None else world
    r = rank() if rank_ is None else rank_
    for k, v in batch.items():
        if hasattr(v, "shape") and len(v.shape) and v.shape[0] % n:
            raise divisibility_error(v.shape[0], k, n)
    out = {}
    for k, v in batch.items():
        if hasattr(v, "shape") and len(v.shape):
            b = v.shape[0] // n
            out[k] = v[r * b:(r + 1) * b]
        else:
            out[k] = v
    return out


def rank_positions(n_samples: int, batch_size: int,
                   rank_: Optional[int] = None,
                   world: Optional[int] = None) -> Tuple[List[int], int]:
    """(positions in an epoch order of ``n_samples`` that this rank loads,
    the rank's rows a batch): of each whole global batch ``j`` of
    ``batch_size`` rows, the positions ``j B + r B/N ...``; the last
    partial batch is dropped, as every data module drops it."""
    n = world_size() if world is None else world
    r = rank() if rank_ is None else rank_
    if batch_size % n:
        raise divisibility_error(batch_size, "batch_size", n)
    b = batch_size // n
    return [j * batch_size + r * b + i for j in range(n_samples // batch_size)
            for i in range(b)], b


def rand_rows(shape: Sequence[int], dim: int = 0, generator=None,
              device=None) -> torch.Tensor:
    """``torch.rand(shape)``, where ``shape[dim]`` counts this rank's rows
    of a global batch: the global tensor is drawn from ``generator`` (every
    rank draws the same) and the rank keeps its rows. The draws, and the
    generator's state after them, are those of one process holding the
    whole batch."""
    n = world_size()
    if n == 1:
        return torch.rand(tuple(shape), generator=generator, device=device)
    full = list(shape)
    rows = full[dim]
    full[dim] = rows * n
    u = torch.rand(tuple(full), generator=generator, device=device)
    return u.narrow(dim, rank() * rows, rows).contiguous()


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over the ranks in place (no gradient), a bf16 tensor in
    f32; returns ``t``."""
    if not active():
        return t
    if t.dtype == torch.bfloat16:
        f = t.float()
        dist.all_reduce(f)
        t.copy_(f)
    else:
        dist.all_reduce(t)
    return t


class _AllReduceSum(torch.autograd.Function):
    """y = sum over ranks of x, on every rank. The global loss is the sum of
    the ranks' losses, each of which reads y, so the gradient reaching x on
    one rank is the sum of every rank's gradient at y."""

    @staticmethod
    def forward(ctx, x):
        return all_reduce_(x.clone(memory_format=torch.contiguous_format))

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.clone(memory_format=torch.contiguous_format))


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the ranks; ``x`` itself without a
    process group."""
    return _AllReduceSum.apply(x) if active() else x


def buckets(tensors: Sequence[torch.Tensor], bucket_bytes: int):
    """Indices of ``tensors`` in buckets of one dtype and device, each of at
    most ``bucket_bytes`` (a larger tensor is a bucket alone)."""
    groups: Dict = {}
    for i, t in enumerate(tensors):
        groups.setdefault((t.dtype, t.device), []).append(i)
    for idx in groups.values():
        cur, size = [], 0
        for i in idx:
            nb = tensors[i].numel() * tensors[i].element_size()
            if cur and size + nb > bucket_bytes:
                yield cur
                cur, size = [], 0
            cur.append(i)
            size += nb
        if cur:
            yield cur


def all_reduce_tensors(tensors: Sequence[torch.Tensor],
                       bucket_bytes: int) -> List[torch.Tensor]:
    """The ranks' sums of ``tensors`` (new tensors, same shapes): flattened
    into buckets, one ``all_reduce`` a bucket. Without a process group the
    tensors themselves."""
    tensors = list(tensors)
    if not active():
        return tensors
    out: List[Optional[torch.Tensor]] = [None] * len(tensors)
    for idx in buckets(tensors, bucket_bytes):
        flat = all_reduce_(torch.cat([tensors[i].reshape(-1) for i in idx]))
        off = 0
        for i in idx:
            n = tensors[i].numel()
            out[i] = flat[off:off + n].view(tensors[i].shape)
            off += n
    return out


def all_reduce_grads(grads: Dict[str, torch.Tensor]
                     ) -> Dict[str, torch.Tensor]:
    """Gradients by name -> their sums over the ranks (the gradient of the
    global loss, each rank's loss being its part of it), in buckets of
    ``BUCKET_BYTES``."""
    keys = list(grads)
    return dict(zip(keys, all_reduce_tensors([grads[k] for k in keys],
                                             BUCKET_BYTES)))


def all_reduce_logs(logs: Dict[str, torch.Tensor]
                    ) -> Dict[str, torch.Tensor]:
    """The ranks' sums of the loss logs (f32 tensors, each a sum over the
    rows of its rank: a loss term, a count), in one collective."""
    keys = list(logs)
    return dict(zip(keys, all_reduce_tensors([logs[k] for k in keys],
                                             2 ** 62)))


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank."""
    if not active():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def all_gather_object(obj) -> list:
    """Every rank's ``obj``, in rank order."""
    if not active():
        return [obj]
    out = [None] * world_size()
    dist.all_gather_object(out, obj)
    return out


@torch.no_grad()
def replicate_state(state) -> None:
    """Rank 0's train state on every rank, in place: the model's
    parameters and buffers, the optimizer's moments and step count, the
    step and the plateau scale (``train/step.py::TrainState``)."""
    if not active():
        return
    for t in list(state.model.parameters()) + list(state.model.buffers()):
        dist.broadcast(t.data, src=0)
    st = state.opt_state
    for k in sorted(st.mu):
        dist.broadcast(st.mu[k], src=0)
    for k in sorted(st.nu):
        dist.broadcast(st.nu[k], src=0)
    st.count, state.step, state.lr_scale = broadcast_object(
        (st.count, state.step, state.lr_scale))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(argv: Sequence[str], n: int, *, env: Optional[Dict] = None,
          cwd: Optional[str] = None) -> List[subprocess.Popen]:
    """Start ``n`` processes of ``python argv...`` as the ranks of one
    process group on this host: ``MASKBEV_COORDINATOR`` (a free localhost
    port), ``MASKBEV_NUM_PROCESSES`` and ``MASKBEV_PROCESS_ID`` set, their
    output on pipes (stderr into stdout). :func:`wait` collects them."""
    port = free_port()
    procs = []
    for r in range(n):
        e = dict(os.environ if env is None else env)
        e.update(MASKBEV_COORDINATOR=f"127.0.0.1:{port}",
                 MASKBEV_NUM_PROCESSES=str(n), MASKBEV_PROCESS_ID=str(r))
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=e, cwd=cwd, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    return procs


def wait(procs: Sequence[subprocess.Popen], timeout: float) -> List[str]:
    """Each process's output once all have ended. When one fails, or the
    time runs out, the others are killed (a rank left alone would wait at
    its next collective) and this raises with every rank's output."""
    outs = [""] * len(procs)

    def read(i):
        outs[i] = procs[i].stdout.read()

    readers = [threading.Thread(target=read, args=(i,), daemon=True)
               for i in range(len(procs))]
    for t in readers:
        t.start()
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if (time.monotonic() > deadline
                    or any(p.poll() for p in procs)):
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for t in readers:
            t.join()
    bad = [(r, p.returncode) for r, p in enumerate(procs) if p.returncode]
    if bad:
        raise RuntimeError(
            f"ranks failed (rank, exit code) {bad}:\n" + "\n".join(
                f"--- rank {r} ---\n{o[-6000:]}" for r, o in enumerate(outs)))
    return outs
