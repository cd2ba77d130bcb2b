"""Process mesh and batch sharding (counterpart of
`ldpc_tpu/parallel/mesh.py`).

The reference shards one program's codeword batch over the devices of a
`jax.sharding.Mesh`, and XLA inserts the psum of the error counters. The
port runs one process per device, the PyTorch idiom: every rank runs the
same step on its own contiguous block of the global batch's lanes, and the
only collective is a sum of the counters (of the importance sampler's
sums) after each batch.

Reference name -> port:

  make_mesh(shape, axes, devices) -> make_mesh(shape, axes, device): a
      `torch.distributed.device_mesh.DeviceMesh` over the whole world, one
      rank a position; the same shape rule and error;
  batch_sharding(mesh)            -> shard_lanes(mesh, B) -> (lane0,
      B_local): this rank's lanes [lane0, lane0 + B_local) of the batch.
      A rank's shard is its position in the mesh, row-major over every
      axis, as P(mesh.axis_names) splits the reference's batch;
  replicated(mesh)                -> nothing: every rank holds its own copy
      of the code, the decoder and the batch's generator;
  the psum XLA inserts            -> all_sum(t, mesh);
  batch_multiple(mesh, tile)      -> the same;
  init_distributed(coordinator, num_processes, process_id)
                                  -> the same, over `torch.distributed`,
      or torchrun's environment when no argument is given.

Backend rule (`pick_backend`): "nccl" when the ranks run on CUDA and
every rank of a host has a card of its own; "gloo" when ranks share a card
(NCCL refuses two ranks on one GPU) or run on the CPU. The ranks of a host
are counted before the process group is made: each rank posts its host
name (`socket.gethostname()`) to the rendezvous store, and a rank's host
is shared by the ranks that posted the same name. So two hosts of four
cards, eight ranks, take NCCL, and eight ranks on one card take gloo.
Under gloo the kernels still run on the card: only the counters, a few
numbers a batch, are copied to the host for the sum and back. The choice
and its reason are printed to stderr. A failed init or collective raises;
nothing carries on with a world of one. Every wait, the rendezvous and
each collective, gives up after TIMEOUT (30 minutes, for both backends).

Work that rank 0 does alone while the others wait (`on_rank0`: the
checkpoint's load, the two-phase tuner's probe, `floor`'s proposal) hands
its result, or the exception it raised, to every rank.
"""
from __future__ import annotations

import datetime
import math
import os
import pickle
import socket
import sys
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..device import DeviceLike, resolve_device

TIMEOUT = datetime.timedelta(minutes=30)
_TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_joined = False     # whether this process joined a world (init_distributed)


def pick_backend(device: DeviceLike, ranks_here: int) -> Tuple[str, str]:
    """(backend, why) for `ranks_here` ranks on this host running on
    `device`."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "gloo", "the ranks run on the CPU"
    cards = torch.cuda.device_count()
    if ranks_here > cards:
        return "gloo", (f"{ranks_here} ranks share {cards} card(s) of this "
                        f"host, which NCCL refuses")
    return "nccl", (f"{ranks_here} rank(s) on this host, each with a card "
                    f"of its own")


def gather_hosts(store, rank: int, world: int, host: str) -> List[str]:
    """Every rank's host name, in rank order, through the rendezvous
    `store` (each rank posts its own and waits for the others')."""
    hosts = dist.PrefixStore("ldpc_tpu_torch/hosts", store)
    hosts.set(str(rank), host)
    keys = [str(r) for r in range(world)]
    hosts.wait(keys)
    return [hosts.get(k).decode() for k in keys]


def host_layout(hosts: Sequence[str], rank: int) -> Tuple[int, int]:
    """(local index, ranks on this host) of `rank`: the ranks whose host
    name is rank's, and rank's place among them in rank order."""
    here = [r for r, h in enumerate(hosts) if h == hosts[rank]]
    return here.index(rank), len(here)


def init_distributed(coordinator: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device: DeviceLike = "cuda") -> str:
    """Join the world of `num_processes` ranks as rank `process_id`,
    meeting at `coordinator` ("host:port" over TCP, or an init_method URL
    such as "file:///path/store"). With no arguments, torchrun's
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT) gives them.
    On CUDA the rank takes the card of its local index (`host_layout`)
    modulo the cards of its host. Returns the backend of `pick_backend`;
    prints it, with its reason, to stderr."""
    if (coordinator, num_processes, process_id) == (None, None, None):
        missing = [k for k in _TORCHRUN_ENV if k not in os.environ]
        if missing:
            raise ValueError(f"init_distributed needs coordinator, "
                             f"num_processes and process_id, or torchrun's "
                             f"environment (missing {missing})")
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs coordinator, "
                         "num_processes and process_id together")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside [0, "
                         f"{num_processes})")
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dev = resolve_device(device)
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    store, _, _ = next(dist.rendezvous(url, process_id, num_processes,
                                       timeout=TIMEOUT))
    store.set_timeout(TIMEOUT)
    local, ranks_here = host_layout(
        gather_hosts(store, process_id, num_processes, socket.gethostname()),
        process_id)
    if dev.type == "cuda":
        torch.cuda.set_device(local % torch.cuda.device_count())
    backend, why = pick_backend(dev, ranks_here)
    dist.init_process_group(backend, store=store, world_size=num_processes,
                            rank=process_id, timeout=TIMEOUT)
    global _joined
    _joined = True
    print(f"# rank {process_id} of {num_processes}: backend {backend} "
          f"({why})", file=sys.stderr, flush=True)
    return backend


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axes: Tuple[str, ...] = ("batch",),
              device: DeviceLike = "cuda"):
    """A DeviceMesh over every rank of the world (`init_distributed` first).

    shape=None is one flat axis of all ranks. For multi-host runs pass
    shape=(n_hosts, ranks_per_host) with axes=("dcn", "ici")."""
    from torch.distributed.device_mesh import init_device_mesh
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call "
                           "init_distributed first (the CLI's "
                           "--num-processes/--coordinator/--process-id, or "
                           "torchrun)")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,)
        axes = axes[:1]
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {shape} != {world} devices")
    if len(axes) != len(shape):
        raise ValueError(f"mesh axes {axes} do not name shape {shape}")
    return init_device_mesh(torch.device(device).type, shape,
                            mesh_dim_names=tuple(axes))


def batch_multiple(mesh, batch_tile: int = 1) -> int:
    """Global batch sizes must divide evenly: n_devices * batch_tile."""
    return mesh.size() * batch_tile


def shard_index(mesh) -> int:
    """This rank's position in the mesh, row-major over every axis."""
    return mesh.mesh.flatten().tolist().index(dist.get_rank())


def shard_lanes(mesh, batch: int) -> Tuple[int, int]:
    """(lane0, local batch): this rank's lanes [lane0, lane0 + B/W) of a
    global batch of B codewords, W = mesh.size()."""
    size = mesh.size()
    if size != dist.get_world_size():
        raise ValueError(f"the mesh has {size} positions, the world "
                         f"{dist.get_world_size()} ranks")
    if batch % size:
        raise ValueError(f"batch {batch} not divisible by mesh size {size}")
    local = batch // size
    return shard_index(mesh) * local, local


def all_sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of `t` over every rank, on t's device (`t` itself without a
    mesh). Under gloo a CUDA tensor crosses the host."""
    if mesh is None:
        return t
    if t.device.type == "cuda" and dist.get_backend() == "gloo":
        host = t.cpu()
        dist.all_reduce(host)
        return host.to(t.device)
    out = t.clone()
    dist.all_reduce(out)
    return out


def is_rank0(mesh=None) -> bool:
    """Whether this process reports: rank 0, or any process without a
    mesh."""
    return mesh is None or dist.get_rank() == 0


def on_rank0(fn, mesh):
    """fn() on rank 0 and its result on every rank (fn() without a mesh).
    What fn raises on rank 0, SystemExit included, is raised on every
    rank, so no rank waits on a result that never comes."""
    if mesh is None:
        return fn()
    out = err = None
    if dist.get_rank() == 0:
        try:
            out = fn()
        except BaseException as e:
            err = e
    box = [(out, _portable(err))]
    dist.broadcast_object_list(box, src=0)
    if err is not None:
        raise err
    out, sent = box[0]
    if sent is not None:
        raise sent
    return out


def _portable(err: Optional[BaseException]) -> Optional[BaseException]:
    """err, or a RuntimeError naming it where err does not pickle."""
    if err is None:
        return None
    try:
        pickle.loads(pickle.dumps(err))
        return err
    except Exception:
        return RuntimeError(f"on rank 0: {err!r}")


def exit_process(code: int) -> None:
    """sys.exit(code); in a process that joined a world, flush stdout and
    stderr and os._exit(code) instead, skipping the interpreter's
    teardown. Under torch 2.13.0+cpu, two-rank gloo worlds that build a
    mesh and run a sweep, then destroy_process_group and exit normally,
    abort now and then under load (exit -6, "terminate called without an
    active exception": what std::terminate prints when a joinable
    std::thread is destroyed); worlds that only all-reduce have not. The
    fault handler then shows the main thread with no Python frame: the
    abort comes after the interpreter's finalization, in the C++ teardown
    at exit. Which object's thread it is is not known. Under torch
    2.11.0+cu128 on the card no world has been torn down through the
    interpreter. Every process that joins a world ends here: the CLI, the
    dry run's ranks, `chip_smoke.py` and its ranks, and the ranks the
    tests spawn."""
    if not _joined:
        sys.exit(code)
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)
