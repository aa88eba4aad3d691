"""Cross-device checks that `chip_smoke.py` and the card tests
(tests/test_torch_cuda.py) both run: one training step on two devices with
the same quantization noise (any trained arch, and the RGB-T master's step
against its frozen guide), a step under `--remat` against the plain step
on one device, the AR codecs' wavefront step on two devices on the same
coded latents, and the transforms of the RGB-T pair, of the paired
`_R`/`_D` archs and of ssf2020's GOP chain stage by stage.

`write_reference_checkpoint` is their test support for zoo/pretrained.py:
it writes a codec as a CompressAI-format file, the layout of the
reference's published weights.

`torch.rand` draws other numbers on the card than on the CPU, so
`fixed_noise` swaps `entropy_models.quantize_noise` for one that adds a
numpy-made U(-0.5, 0.5) noise, the same for a given shape on any device.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from lmic_tpu_torch import zoo
from lmic_tpu_torch.entropy import entropy_models
from lmic_tpu_torch.ops import gdn
from lmic_tpu_torch.utils.train import (
    create_train_state,
    make_optimizer,
    make_train_step,
)


@contextlib.contextmanager
def fixed_noise(seed: int = 0, rank: int = 0, world: int = 1):
    """Within the block, training noise is drawn from numpy (`seed`, and
    the order in which shapes first appear), not from the generator. As
    rank `rank` of `world` data-parallel ranks, each draw is of the global
    batch's shape and the rank takes its rows of it (its block of the
    batch dim: the first of an NCHW tensor, the last of the bottleneck's
    (C, 1, B*H*W) values), so the ranks together add the noise of one
    process stepping on the whole batch."""
    cache: Dict[tuple, torch.Tensor] = {}

    def quantize_noise(x, generator=None):
        dim = 2 if x.dim() == 3 else 0
        n = x.shape[dim]
        key = x.shape[:dim] + (n * world,) + x.shape[dim + 1:]
        if key not in cache:
            rng = np.random.default_rng([seed, len(cache)])
            cache[key] = torch.from_numpy(
                rng.uniform(-0.5, 0.5, key).astype(np.float32))
        noise = cache[key].narrow(dim, rank * n, n)
        return x + noise.to(x.device, x.dtype)

    original = entropy_models.quantize_noise
    entropy_models.quantize_noise = quantize_noise
    try:
        yield
    finally:
        entropy_models.quantize_noise = original


def _step_agreement(runs, step_on):
    """`step_on(run)` -> (metrics, module) for each of two `runs` (two
    devices, or the remat and the plain step) under `fixed_noise`. Returns
    (loss_err, grad_err, launched): the largest relative difference of the
    step's losses, the largest difference of a clipped gradient leaf
    relative to that leaf's largest value in the second run, and the GDN
    kernel launches of the first run."""
    results, launched = [], None
    with fixed_noise():
        for run in runs:
            before = dict(gdn.LAUNCHES)
            metrics, module = step_on(run)
            if launched is None:
                if next(module.parameters()).is_cuda:
                    torch.cuda.synchronize()
                launched = {k: gdn.LAUNCHES[k] - before[k]
                            for k in before}
            results.append((
                {k: float(v) for k, v in metrics.items()},
                {n: p.grad.detach().float().cpu()
                 for n, p in module.named_parameters()},
            ))
    (m_a, g_a), (m_b, g_b) = results
    loss_err = max(abs(m_a[k] - m_b[k]) / abs(m_b[k]) for k in m_b)
    grad_err = max(((g_a[n] - g_b[n]).abs().max()
                    / g_b[n].abs().max().clamp(min=1e-30)).item()
                   for n in g_b)
    return loss_err, grad_err, launched


def train_step_agreement(arch: str, quality: int, x: torch.Tensor,
                         lmbda: float, devices: Sequence[str] = ("cuda",
                                                                 "cpu"),
                         **widths):
    """One step of `arch` (any arch `train_cli` trains alone, the AR
    family and the RGB-T guide included; weights from seed 0, `widths` as
    `N=`/`M=`) on the NCHW batch `x` on each of two `devices`, under
    `fixed_noise`: (loss_err, grad_err, launched) of `_step_agreement`."""

    def step_on(device):
        module = zoo.create_model(arch, quality, seed=0, device=device,
                                  **widths).module
        opt = make_optimizer()
        _, metrics = make_train_step(module, opt, lmbda)(
            create_train_state(module, opt), x.to(device))
        return metrics, module

    return _step_agreement(devices, step_on)


def remat_step_agreement(arch: str, quality: int, x: torch.Tensor,
                         lmbda: float, device: str = "cuda",
                         dtype: Optional[torch.dtype] = None, **widths):
    """One step of `arch` under `--remat` against the plain step, both on
    `device` from seed 0 (`dtype` the compute dtype, bfloat16 for AMP) on
    the NCHW batch `x`, under `fixed_noise`: (loss_err, grad_err,
    launched) of `_step_agreement`, launched the remat step's."""

    def step_on(remat):
        module = zoo.create_model(arch, quality, seed=0, device=device,
                                  dtype=dtype, **widths).module
        opt = make_optimizer()
        _, metrics = make_train_step(module, opt, lmbda, remat=remat)(
            create_train_state(module, opt), x.to(device))
        return metrics, module

    return _step_agreement((True, False), step_on)


def master_step_agreement(quality: int, channel: int, x: torch.Tensor,
                          guide: torch.Tensor, lmbda: float,
                          devices: Sequence[str] = ("cuda", "cpu"),
                          remat: Sequence[bool] = (False, False),
                          **widths):
    """One master step (`train_cli.make_master_train_step`) of a master
    of `channel` channels against its frozen guide (seed 0, first conv at
    stride 2; the master from seed 1) on the NCHW master batch `x` and
    guide batch `guide`, on each of two `devices` (with `remat[i]` on the
    i-th), under `fixed_noise`: (loss_err, grad_err, launched) of
    `_step_agreement`."""
    from lmic_tpu_torch.utils.train_cli import make_master_train_step

    def step_on(run):
        device, rematerialized = run
        guided = zoo.create_model("guided", quality, seed=0,
                                  channel=4 - channel, first_stride=2,
                                  device=device, **widths).module
        guided.eval().requires_grad_(False)
        master = zoo.create_model("master", quality, seed=1,
                                  channel=channel, device=device,
                                  **widths).module
        opt = make_optimizer()
        _, metrics = make_master_train_step(
            master, guided, opt, lmbda, remat=rematerialized)(
            create_train_state(master, opt), x.to(device),
            guide.to(device))
        return metrics, master

    return _step_agreement(tuple(zip(devices, remat)), step_on)


def data_parallel_steps(arch: str, quality: int, x: torch.Tensor,
                        lmbda: float, device, steps: int = 2,
                        dtype: Optional[torch.dtype] = None, rank: int = 0,
                        world: int = 1, data_parallel: bool = False,
                        **widths) -> Dict[str, object]:
    """`steps` train steps of `arch` (weights from seed 0, `dtype` the
    compute dtype, `widths` as `N=`/`M=`) on `device`, on rank `rank`'s
    rows of the NCHW global batch `x`, under `fixed_noise(rank=, world=)`;
    with `data_parallel`, under DistributedDataParallel in the current
    process group (`parallel.launch` or `parallel.process_group`).

    Returns the metrics of each step ({name: float}, the ranks' means),
    the first step's gradients as one f32 vector on the host (after the
    all-reduce and the clip), a sha256 of the parameters' bytes after
    each step, the parameters after the last step as one vector, and the
    GDN kernel launches by CUDA kernel (`gdn.kernel_launches`) and by
    wrapper (`gdn.LAUNCHES`)."""
    import hashlib

    from lmic_tpu_torch import parallel

    module = zoo.create_model(arch, quality, seed=0, device=device,
                              dtype=dtype, **widths).module
    opt = make_optimizer()
    step = make_train_step(module, opt, lmbda, data_parallel=data_parallel)
    state = create_train_state(module, opt)
    batch = parallel.rank_rows(x, rank, world).to(device).contiguous(
        memory_format=torch.channels_last)

    def flat(tensors):
        return torch.cat([t.detach().float().reshape(-1).cpu()
                          for t in tensors])

    out = {"metrics": [], "param_sha256": []}
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    kernels, wrappers = gdn.kernel_launches(), dict(gdn.LAUNCHES)
    with fixed_noise(rank=rank, world=world):
        for i in range(steps):
            state, metrics = step(state, batch)
            out["metrics"].append({k: float(v) for k, v in metrics.items()})
            if i == 0:
                out["grads"] = flat(p.grad for p in module.parameters())
            params = flat(module.parameters())
            out["param_sha256"].append(
                hashlib.sha256(params.numpy().tobytes()).hexdigest())
    out["params"] = params
    after = gdn.kernel_launches()
    out["kernel_launches"] = {k: v - kernels.get(k, 0)
                              for k, v in after.items()
                              if v != kernels.get(k, 0)}
    out["launches"] = {k: v - wrappers[k] for k, v in gdn.LAUNCHES.items()}
    return out


def data_parallel_rank(rank: int, world: int, device, arch: str,
                       quality: int, x: torch.Tensor, lmbda: float,
                       steps: int, dtype, timed: int, out_dir: str):
    """One rank of a data-parallel run (`parallel.launch`'s entry):
    `data_parallel_steps` under DDP, then `timed` steps on the rank's
    rows with the rank's own noise generator, each timed on the host
    clock between two synchronizes, the last under torch.profiler. On
    CUDA also that step's device ms, the share of it that the all-reduce
    takes (NCCL's kernels, or the copies through host memory that gloo
    stages CUDA tensors in) and the peak memory; on the CPU these are
    None. Writes the results to `out_dir`/rank<r>.pt."""
    import time

    from torch.profiler import ProfilerActivity, profile

    from lmic_tpu_torch import parallel

    res = data_parallel_steps(arch, quality, x, lmbda, device, steps, dtype,
                              rank, world, data_parallel=True)
    if rank:
        del res["params"]
    on_card = torch.device(device).type == "cuda"
    module = zoo.create_model(arch, quality, seed=0, device=device,
                              dtype=dtype).module
    opt = make_optimizer()
    step = make_train_step(module, opt, lmbda, data_parallel=True)
    state = create_train_state(module, opt)
    batch = parallel.rank_rows(x, rank, world).to(device).contiguous(
        memory_format=torch.channels_last)
    gen = torch.Generator(device=device).manual_seed(
        parallel.rank_seed(0, rank))

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    if on_card:
        torch.cuda.reset_peak_memory_stats(device)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if on_card else [])
    wall = []
    for i in range(timed):
        last = i == timed - 1
        sync()
        t0 = time.perf_counter()
        with (profile(activities=activities) if last
              else contextlib.nullcontext()) as prof:
            state, _ = step(state, batch, gen)
            sync()
        wall.append(1e3 * (time.perf_counter() - t0))
    res.update(step_wall_ms=wall, step_device_ms=None,
               allreduce_device_share=None, peak_gib=None)
    if on_card:
        total = comm = 0.0
        for evt in prof.key_averages():
            if (evt.device_type != torch.autograd.DeviceType.CUDA
                    or evt.is_user_annotation):
                continue
            total += evt.self_device_time_total
            if "nccl" in evt.key.lower() or "memcpy" in evt.key.lower():
                comm += evt.self_device_time_total
        res.update(step_device_ms=total / 1e3,
                   allreduce_device_share=comm / total if total else None,
                   peak_gib=torch.cuda.max_memory_allocated(device) / 2**30)
    torch.save(res, f"{out_dir}/rank{rank}.pt")


def wavefront_step_agreement(codec, ref, x):
    """The wavefront step of the AR `codec` against that of `ref` (the
    same weights and tables on another device, the plain path on the CPU)
    for the one image `x` (1, H, W, 3): both run every step on the
    latents and wire z symbols that `ref` encodes, each with its own hyper
    transform.

    Returns (err, flips, n): the largest difference of scales or means
    relative to max(1, max|ref's|) over all steps, and how many of the n
    scale indexes differ."""
    from lmic_tpu_torch.models.joint import PAD

    with torch.inference_mode():
        ys, z_sym = ref._analyze(x)
        y_hat = ref._code_y_z(ys, z_sym, keep_y_hat=True)["y_hat_latent"]
        M, H, W = y_hat.shape[1:]
        # the padded HWC buffer of the wavefront loop, fully coded: step t
        # reads only what was coded before it
        buf = F.pad(y_hat[0].permute(1, 2, 0),
                    (0, 0, PAD, PAD, PAD, PAD)).reshape(-1, M)
        outs = []
        for c in (codec, ref):
            sched, prepare, step = c._step_for(H, W)
            pre1 = prepare(c._hyper_params(z_sym))
            b = buf.to(c.device)
            outs.append([[v.cpu() for v in step(t, b, pre1)]
                         for t in range(sched.T)])
    err, flips, n = 0.0, 0, 0
    for (s_a, m_a, i_a), (s_b, m_b, i_b) in zip(*outs):
        for a, b in ((s_a, s_b), (m_a, m_b)):
            err = max(err, ((a - b).abs().max()
                            / b.abs().max().clamp(min=1.0)).item())
        flips += int((i_a != i_b).sum())
        n += i_b.numel()
    return err, flips, n


class _Stages:
    """Runs a stage of a tuple of codecs on two devices: `stage(*modules,
    *args)` on `codecs`' modules and on `ref`'s, the args (tensors, or
    dicts of them) copied to each device. Returns `codecs`' outputs,
    flattened (a dict's values in order); `worst` is the largest error of
    any output so far, max|a - b| / max(1, max|b|)."""

    def __init__(self, codecs, ref):
        self.sides = ((codecs, codecs[-1].device), (ref, ref[-1].device))
        self.worst = 0.0

    def __call__(self, stage, *args):
        flat = []
        for codecs, dev in self.sides:
            a = [{k: v.to(dev) for k, v in t.items()} if isinstance(t, dict)
                 else t.to(dev) for t in args]
            out = []
            for t in stage(*(c.module for c in codecs), *a):
                out += list(t.values()) if isinstance(t, dict) else [t]
            flat.append(out)
        for a, b in zip(*flat):
            a, b = a.float().cpu(), b.float().cpu()
            self.worst = max(self.worst, ((a - b).abs().max()
                                          / b.abs().max().clamp(min=1.0)
                                          ).item())
        return flat[0]


def rgbt_agreement(pair, ref, x, guide) -> float:
    """The RGB-T pair `pair` = (guided, master) codecs against `ref`, the
    same pair on another device, on a master image `x` and its `guide`
    ((1, H, W, C) numpy): each stage (the guide's g_a and g_s with their
    maps, the master's features, analysis and synthesis) runs on `pair`'s
    outputs of the stage before, copied to each device, so a rounding of
    the latents cannot flip on one side only. Returns the largest error of
    any output, max|a - b| / max(1, max|b|)."""
    both = _Stages(pair, ref)
    guided, master = pair
    with torch.inference_mode():
        y = both(lambda g, m, t: g.g_a_hidden(t),
                 guided._pixels(guide))[0]
        g_hat, *gs = both(lambda g, m, t: g.g_s_hidden(t), torch.round(y))
        gs = dict(zip(("gs1", "gs2", "gs3"), gs))
        feat, align, _, _ = both(lambda g, m, a, b: m.features(a, b),
                                 master._pixels(x),
                                 torch.clamp(g_hat, 0.0, 1.0))
        ym, _ = both(lambda g, m, a, b: m.analyze_features(a, b), feat,
                     align)
        both(lambda g, m, *a: [m.synthesize(*a)], torch.round(ym), gs, align)
    return both.worst


def paired_agreement(pair, ref, x, guide) -> float:
    """A paired RGB-T couple `pair` = (the `_R` guide codec, the `_D`
    dependent codec) against `ref`, the same couple on another device, on
    a dependent image `x` and its same-size `guide` ((1, H, W, C) numpy),
    stage by stage as `rgbt_agreement`: the guide's g_a and g_s with
    their maps, the dependent's fused analysis (y, z) on the ga* maps and
    its fused synthesis on the gs* maps. Returns the largest error."""
    both = _Stages(pair, ref)
    guide_codec, codec = pair
    with torch.inference_mode():
        y, *ga = both(lambda r, d, t: r.g_a_hidden(t),
                      guide_codec._pixels(guide))
        _, *gs = both(lambda r, d, t: r.g_s_hidden(t), torch.round(y))
        yd, _ = both(lambda r, d, a, h: d.analyze_fused(a, h),
                     codec._pixels(x), dict(zip(("ga1", "ga2", "ga3"), ga)))
        both(lambda r, d, a, h: [d.g_s_fused(a, h)], torch.round(yd),
             dict(zip(("gs1", "gs2", "gs3"), gs)))
    return both.worst


def video_agreement(codec, ref, frames) -> float:
    """An ssf2020 codec against `ref`, the same weights on another device,
    on a GOP `frames` ((1, T, H, W, 3) numpy), stage by stage as
    `rgbt_agreement`: the keyframe's analysis, hyper analysis, entropy
    parameters and synthesis; for each inter frame the motion analysis,
    its hyperprior, the motion decoder, the scale-space warp
    (`forward_prediction`), the residual analysis, its hyperprior and the
    residual synthesis, each on `codec`'s outputs of the stage before.
    Returns the largest error of any output."""
    both = _Stages((codec,), (ref,))

    def hyper(y, which):
        z, = both(lambda m, t: [m.hp_encode_z(t, which)], y)
        both(lambda m, t: m.hp_params(t, which), torch.round(z))

    with torch.inference_mode():
        x = codec._frames(frames)
        y, = both(lambda m, t: [m.img_encode(t)], x[:, 0])
        hyper(y, "img")
        x_ref, = both(lambda m, t: [m.img_decode(t)], torch.round(y))
        for i in range(1, x.shape[1]):
            ym, = both(lambda m, a, b: [m.motion_encode(a, b)], x[:, i],
                       x_ref)
            hyper(ym, "motion")
            ym = torch.round(ym)
            info, = both(lambda m, t: [m.motion_decoder(t)], ym)
            x_pred, = both(lambda m, a, b: [m.forward_prediction(a, b)],
                           x_ref, info)
            yr, = both(lambda m, t: [m.res_encode(t)], x[:, i] - x_pred)
            hyper(yr, "res")
            x_res, = both(lambda m, a, b: [m.res_decode(a, b)],
                          torch.round(yr), ym)
            x_ref = x_pred + x_res
    return both.worst


# what a CompressAI GDN's reparametrizations hold as buffers
# (compressai/ops/parametrizers.py): pedestal = 2^-36 and the lower bounds
# sqrt(minimum + pedestal), beta's minimum 1e-6
_PEDESTAL = 2.0 ** -36


def coding_states(codec) -> Dict[str, object]:
    """{key prefix of an entropy model in a CompressAI file: its coding
    state} of `codec` (either package's: the same attributes)."""
    if getattr(codec, "hp_states", None):
        pairs = {f"{which}_hyperprior.": (hp.eb_state, hp.gc_state)
                 for which, hp in codec.hp_states.items()}
    else:
        pairs = {"": (codec.eb_state, codec.gc_state)}
    out = {}
    for prefix, (eb, gc) in pairs.items():
        out[prefix + "entropy_bottleneck"] = eb
        if gc is not None:
            out[prefix + "gaussian_conditional"] = gc
    return out


def reference_table_mismatches(codec, state_dict) -> list:
    """The entropy models of `codec` whose coding tables differ, in any
    bit, from the baked buffers of the reference `state_dict` (the CDFs,
    lengths and offsets as int32, the medians `quantiles[:, 0, 1]` and
    the scale table as f32): an empty list when every table is the
    file's."""
    bad = []
    for prefix, st in coding_states(codec).items():
        got = [st.table.cdf, st.table.cdf_length, st.table.offset]
        want = [state_dict[f"{prefix}.{k}"] for k in
                ("_quantized_cdf", "_cdf_length", "_offset")]
        if prefix.endswith("entropy_bottleneck"):
            got.append(st.medians)
            want.append(state_dict[f"{prefix}.quantiles"][:, 0, 1])
        else:
            got.append(st.scale_table)
            want.append(state_dict[f"{prefix}.scale_table"])
        for g, w in zip(got, want):
            g, w = np.asarray(g), w.cpu().numpy()
            if g.dtype != w.dtype or g.dtype not in (np.int32, np.float32) \
                    or not np.array_equal(g.view(np.int32),
                                          w.view(np.int32)):
                bad.append(prefix)
                break
    return bad


def write_reference_checkpoint(path: str, codec, baked: bool = True,
                               extra: Optional[Mapping[str, torch.Tensor]]
                               = None) -> Dict[str, torch.Tensor]:
    """Write `codec` as a CompressAI-format state_dict file (the reference
    `update_model`'s deployment layout): `codec.module.state_dict()`, the
    reference's non-parameter buffers (GDN reparametrization pedestals and
    bounds, the context model's mask, the entropy models' `target` and
    bounds), with `baked` the codec's coding tables as
    `_quantized_cdf/_offset/_cdf_length` and `scale_table`, and `extra`
    (e.g. the modules an RGB-T class inherits and never runs). Old
    spellings show as in older files: every key under `module.`
    (DataParallel), one bottleneck's `_matrix0` as `_matrices.0` and one
    `skip` as `downsample`. Returns the state_dict written, with the
    current key names."""
    from lmic_tpu_torch.layers import GDN, MaskedConv2d

    sd = {k: v.detach().cpu().clone()
          for k, v in codec.module.state_dict().items()}
    for name, m in codec.module.named_modules():
        if isinstance(m, GDN):
            sd[f"{name}.beta_reparam.pedestal"] = torch.tensor(_PEDESTAL)
            sd[f"{name}.beta_reparam.lower_bound.bound"] = torch.tensor(
                (1e-6 + _PEDESTAL) ** 0.5)
            sd[f"{name}.gamma_reparam.pedestal"] = torch.tensor(_PEDESTAL)
            sd[f"{name}.gamma_reparam.lower_bound.bound"] = torch.tensor(
                _PEDESTAL ** 0.5)
        elif isinstance(m, MaskedConv2d):
            sd[f"{name}.mask"] = m.mask.cpu().expand_as(m.weight).clone()
    for prefix, st in coding_states(codec).items():
        table = st.table
        scales = getattr(st, "scale_table", None)
        sd[f"{prefix}.likelihood_lower_bound.bound"] = torch.tensor(1e-9)
        if scales is None:
            t = math.log(2 / 1e-9 - 1)  # the bottleneck's tail target
            sd[f"{prefix}.target"] = torch.tensor([-t, 0.0, t])
        else:
            sd[f"{prefix}.lower_bound_scale.bound"] = torch.tensor(0.11)
            if baked:
                sd[f"{prefix}.scale_table"] = torch.from_numpy(
                    np.array(scales, np.float32))
        if baked:
            sd[f"{prefix}._quantized_cdf"] = torch.from_numpy(
                np.array(table.cdf, np.int32))
            sd[f"{prefix}._offset"] = torch.from_numpy(
                np.array(table.offset, np.int32))
            sd[f"{prefix}._cdf_length"] = torch.from_numpy(
                np.array(table.cdf_length, np.int32))
    sd.update({k: v.detach().cpu() for k, v in (extra or {}).items()})
    old, matrices, skip = {}, False, False
    for k, v in sd.items():
        if not matrices and k.endswith("._matrix0"):
            k, matrices = k.replace("._matrix0", "._matrices.0"), True
        elif not skip and ".skip." in k:
            k, skip = k.replace(".skip.", ".downsample."), True
        old["module." + k] = v
    torch.save(old, path)
    return sd
