"""Data parallelism over local devices.

Counterpart of lmic_tpu/parallel/__init__.py. lmic_tpu's strategy is SPMD
data parallelism over a 1-D `data` mesh: parameters replicated, the batch
sharded over the axis, gradients reduced by collectives. Here:

- training runs one process per mesh device under
  `torch.nn.parallel.DistributedDataParallel` (`launch`, `data_parallel`):
  each rank takes its contiguous rows of the same global batch
  (`rank_rows`), and DDP's all-reduce leaves every rank the mean gradient,
  which is the gradient of the global batch's loss;
- serving scales a codec over a mesh with `shard_codec`: the
  wire-determining graphs run per image, round-robin over the mesh, and
  the batch-safe graphs split their batch into row blocks, one a device;
  the AR and video codecs fan whole images or sequences out, one worker
  thread a device (`models/codec.py` `_FanOut`).

A `Mesh` is an ordered list of devices of one kind (`check_homogeneous`).
The same device may stand in it more than once: `Mesh(["cuda:0",
"cuda:0"])` is two slots on one card.
"""

from __future__ import annotations

import contextlib
import copy
import itertools
import os
import shutil
import tempfile
from typing import List, Optional, Sequence

import numpy as np
import torch

DATA_AXIS = "data"


def _normal(device) -> torch.device:
    """`device` as a torch.device; a CUDA device without an index is the
    current one (the device its tensors report)."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


def check_homogeneous(devices) -> List[torch.device]:
    """The devices as a list, when they are of one kind: one device type,
    and for CUDA one `torch.cuda.get_device_name`. Fan-out serving
    recomputes the entropy parameters on both sides of the wire, and a
    stream decodes only where they round as they did when it was encoded;
    lmic_tpu's contract is the same platform on both sides
    (docs/architecture.md, "Determinism"), so a mixed set raises.

    Across platforms it is not promised: mbt2018-mean q8 on a 512x768
    image, coded on an NVIDIA H100 and decoded on the host CPU and the
    reverse (chip_smoke.py phase 15, the card's tables on both), gave
    equal strings, no scale index that differed and pixels within one
    level, but a single ulp in the hyper synthesis can move an index
    across a bucket edge on another input."""
    devices = [_normal(d) for d in devices]
    if not devices:
        raise ValueError("an empty device set")
    types = {d.type for d in devices}
    if len(types) > 1:
        raise ValueError(f"heterogeneous device set: {sorted(types)}")
    if types == {"cuda"}:
        names = {torch.cuda.get_device_name(d) for d in devices}
        if len(names) > 1:
            raise ValueError(f"heterogeneous device set: {sorted(names)}")
    return devices


class Mesh:
    """A 1-D mesh: an ordered list of devices of one kind along `axis`."""

    def __init__(self, devices: Sequence, axis: str = DATA_AXIS):
        self.devices = check_homogeneous(devices)
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis!r})"


def make_mesh(n_devices: Optional[int] = None, device=None,
              axis: str = DATA_AXIS) -> Mesh:
    """A 1-D mesh over the first `n_devices` local CUDA devices (all of
    them by default), as lmic_tpu's over `jax.devices()[:n]`. The CPU only
    when asked (`device="cpu"`: `n_devices` entries of it, one by
    default); without a GPU and without that request it raises."""
    kind = "cuda" if device is None else torch.device(device).type
    if kind == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1), axis)
    if kind != "cuda":
        raise ValueError(f"no mesh of {kind!r} devices")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "make_mesh: no GPU is available; pass device=\"cpu\" for a "
            "mesh of CPU entries")
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"a mesh of {n} CUDA devices; {count} present")
    return Mesh([torch.device("cuda", i) for i in range(n)], axis)


def rank_rows(batch, rank: int, world: int):
    """Rank `rank`'s contiguous block of rows of a global `batch` (an
    array or tensor, or a tuple of them) split into `world` equal blocks
    in order; the row count must divide."""
    if isinstance(batch, tuple):
        return tuple(rank_rows(b, rank, world) for b in batch)
    B = batch.shape[0]
    if B % world:
        raise ValueError(f"a batch of {B} rows does not split over "
                         f"{world} devices")
    b = B // world
    return batch[rank * b:(rank + 1) * b]


def shard_batch(mesh: Mesh, batch) -> list:
    """A host or device batch (an array or tensor, or a tuple of them) as
    contiguous row blocks in order, one on each mesh device."""
    def put(block, device):
        if isinstance(block, tuple):
            return tuple(put(b, device) for b in block)
        if isinstance(block, np.ndarray):
            block = torch.from_numpy(np.ascontiguousarray(block))
        return block.to(device)

    return [put(rank_rows(batch, r, mesh.size), d)
            for r, d in enumerate(mesh.devices)]


def _device_of(module) -> Optional[torch.device]:
    t = next(itertools.chain(module.parameters(), module.buffers()), None)
    return None if t is None else t.device


def replicate(mesh: Mesh, module) -> list:
    """`module` on each mesh device, in mesh order: the module itself
    where it already lives (or where it holds no tensors), else one deep
    copy per device, made now. A copy does not follow later changes of
    the weights: replicate again after them."""
    here = _device_of(module)
    copies = {}
    for d in mesh.devices:
        if d not in copies:
            copies[d] = (module if here is None or here == d
                         else copy.deepcopy(module).to(d))
    return [copies[d] for d in mesh.devices]


def shard_codec(codec, mesh: Mesh):
    """Scale a codec's uint8 fast path across a mesh, as lmic_tpu's does:

    - the wire-determining graphs (the analysis transforms, the hyper
      synthesis) run per image (`models/codec.py` `_PerItem`, batch size
      1, so batch grouping never reaches the wire), round-robin over the
      mesh, every device running the same graph on its own copy of the
      weights;
    - the batch-safe graphs (the y symbols, the synthesis) split their
      batch into contiguous row blocks, one a device (`_Sharded`); the
      layout-only pack runs on the first device, where the results
      gather.

    The AR and video codecs fan whole images or sequences out instead
    (`fanout`). Feed batches whose size the mesh size divides. The
    sharding survives `_build_u8_fns` rebuilds (new tables) and a second
    `shard_codec` onto another mesh."""
    codec._check_updated()
    if hasattr(codec, "bundle_meta"):
        raise ValueError(
            "AOT serving bundles are frozen at a fixed input shape and "
            "cannot be re-sharded; shard the live codec BEFORE export "
            "(then load_serving_bundle(path, mesh=...)), or export "
            "per-device bundles and fan out at the caller level")
    if hasattr(codec, "fanout"):
        return codec.fanout(mesh.devices)
    if not hasattr(codec, "_build_u8_fns"):
        raise ValueError(f"{type(codec).__name__} has no u8 fast path")
    # a table change rebuilds the fast path through `_build_u8_fns`;
    # shadowing it on the instance re-applies the sharding each time, and
    # `_shard_spec` is set first so a re-shard builds once, on the new mesh
    first = not hasattr(codec, "_shard_spec")
    codec._shard_spec = mesh
    if first:
        inner_build = codec._build_u8_fns

        def build_and_shard():
            inner_build()
            _apply_codec_sharding(codec, codec._shard_spec)

        codec._build_u8_fns = build_and_shard
    codec._build_u8_fns()
    codec._built_for = {**codec.__dict__.get("_built_for", {}),
                        "_build_u8_fns": (codec.eb_state, codec.gc_state)}
    return codec


# the batch-safe graphs of the fast path that split their batch over the
# mesh; `_pack_enc` and the factorized pack are layout over the whole
# batch and run where the blocks gather
_SHARDED = ("_dec_u8", "_ysym", "_synth_u8")
_PER_ITEM = ("_enc_u8", "_enc_u8_packed", "_analyze_u8", "_params_from_zsym")


def _apply_codec_sharding(codec, mesh: Mesh) -> None:
    from lmic_tpu_torch.models.codec import _PerItem, _Sharded

    for name in _PER_ITEM:
        fn = getattr(codec, name, None)
        if isinstance(fn, _PerItem):
            fn.place(mesh.devices, replicate(mesh, fn.inner))
    for name in _SHARDED:
        fn = getattr(codec, name, None)
        if fn is not None:
            setattr(codec, name, _Sharded(mesh.devices,
                                          replicate(mesh, fn)))


# -- training: one process a device ------------------------------------------


@contextlib.contextmanager
def process_group(backend: str, rank: int = 0, world: int = 1,
                  init_file: Optional[str] = None):
    """A process group of `world` ranks for the block, this process rank
    `rank`, rendezvous through `init_file` (a new temporary file when
    None, for a group of one: `data_parallel` in this process)."""
    tmp = None
    if init_file is None:
        if world != 1:
            raise ValueError("the ranks of a group share one init_file")
        tmp = tempfile.mkdtemp(prefix="lmic-rdv-")
        init_file = os.path.join(tmp, "rdv")
    torch.distributed.init_process_group(
        backend, init_method=f"file://{init_file}", world_size=world,
        rank=rank)
    try:
        yield
    finally:
        torch.distributed.destroy_process_group()
        if tmp is not None:
            shutil.rmtree(tmp, ignore_errors=True)


def _rank_entry(rank, fn, devices, backend, init_file, args):
    device = devices[rank]
    if device.type == "cpu":
        # the CPU convs split their sums by the thread count
        torch.set_num_threads(1)
    else:
        torch.cuda.set_device(device)
    with process_group(backend, rank, len(devices), init_file):
        fn(rank, len(devices), device, *args)


def launch(fn, mesh: Mesh, *args, backend: Optional[str] = None):
    """Run `fn(rank, world, device, *args)` in one spawned process per
    mesh device, rank r on `mesh.devices[r]`, each in one process group:
    NCCL on CUDA and gloo on the CPU unless `backend` says otherwise (NCCL
    refuses two ranks on one GPU; gloo all-reduces CUDA tensors through
    host memory). The rendezvous is a file in a temporary directory, no
    TCP port. `fn` must be importable by name (the children start from a
    fresh import). Raises, with the child's traceback, if a rank fails."""
    import torch.multiprocessing as mp

    if backend is None:
        backend = "nccl" if mesh.devices[0].type == "cuda" else "gloo"
    tmp = tempfile.mkdtemp(prefix="lmic-rdv-")
    try:
        mp.start_processes(
            _rank_entry,
            args=(fn, mesh.devices, backend, os.path.join(tmp, "rdv"), args),
            nprocs=mesh.size, join=True, start_method="spawn")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def data_parallel(module, device):
    """`module` under DistributedDataParallel in the current process
    group, on `device`. Every parameter gets its gradient in the step's
    one backward (the aux loss reaches the quantiles), so unused
    parameters are not searched for; the buffers are constants and are
    not broadcast."""
    from torch.nn.parallel import DistributedDataParallel

    device = torch.device(device)
    return DistributedDataParallel(
        module, device_ids=[device] if device.type == "cuda" else None,
        broadcast_buffers=False, find_unused_parameters=False)


def mean_over_ranks(metrics: dict) -> dict:
    """The mean of each 0-d metric over the ranks of the process group,
    in one all-reduce: the global batch's value, the shards being equal."""
    keys = list(metrics)
    stacked = torch.stack([metrics[k].float() for k in keys])
    torch.distributed.all_reduce(stacked)
    stacked /= torch.distributed.get_world_size()
    return dict(zip(keys, stacked.unbind()))


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank `rank`'s noise generator: the seed itself on rank
    0 (a one-rank run draws the noise of a run without DDP), another
    stream on every other rank, so the shards get independent noise."""
    return seed if rank == 0 else int(
        np.random.SeedSequence([seed, rank]).generate_state(1)[0])
