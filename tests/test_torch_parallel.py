"""The port's data parallelism (lmic_tpu_torch/parallel/) against lmic_tpu's
on the CPU: a two-process gloo DistributedDataParallel step against
lmic_tpu's step over a two-device mesh (conftest's CPU devices) and
against the port's one-process step, on carried weights and the same
numpy noise; `train_cli --devices`; codecs sharded or fanned out over a
two-entry CPU mesh against the single-device codec and lmic_tpu's
`shard_codec` (the RGB-T pair's and ssf2020's cases are in
test_torch_rgbt.py and test_torch_video_codec.py, beside their
fixtures); serving bundles over a mesh; the device checks.

The ranks are spawned processes that import tests/torch_parallel_worker.py
(no JAX) or the port's CLI, once per test that needs them."""

import copy
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parallel_worker import noise, rows_of_global_noise
from torch_port_helpers import (
    M,
    N,
    carry_tables,
    jax_codec,
    jax_params,
    pixels,
    port_codec,
    write_images,
)

import torch_parallel_worker
from lmic_tpu import parallel as jparallel
from lmic_tpu import zoo as jzoo
from lmic_tpu.entropy import entropy_models as jem
from lmic_tpu.utils import train as jtrain
from lmic_tpu_torch import parallel, zoo as tzoo
from lmic_tpu_torch.entropy import entropy_models as tem
from lmic_tpu_torch.utils import checkpoint as ckpt
from lmic_tpu_torch.utils import train as ttrain
from lmic_tpu_torch.utils import train_cli
from lmic_tpu_torch.utils.aot import (
    export_serving_bundle,
    load_serving_bundle,
)
from lmic_tpu_torch.zoo.convert import state_dict_from_jax

torch.set_num_threads(2)
LMBDA = 1024.0
ARCH = "mbt2018-mean"
DDP_BATCH = (4, 64, 64, 3)
CHECK_BATCH = (2, 64, 64, 3)
MESH = 2


# lmic_tpu's init at the test widths, shared by the tests of one arch
_params = functools.lru_cache(maxsize=None)(jax_params)


def _cpu_mesh(n=MESH):
    return parallel.make_mesh(n, device="cpu")


# -- the data-parallel step ---------------------------------------------------


def _jax_noise(x, key):
    shape = tuple(x.shape)
    if len(shape) == 4:  # GaussianConditional input, NHWC
        return x + jnp.asarray(noise((shape[0], shape[3], shape[1],
                                      shape[2])).transpose(0, 2, 3, 1),
                               x.dtype)
    return x + jnp.asarray(noise(shape), x.dtype)


@pytest.fixture(scope="module")
def ddp_run(tmp_path_factory):
    """The weights, the batch and the two ranks' results of one DDP step,
    and the directory where the same two ranks left chip_smoke.py's
    two-rank check on CHECK_BATCH (spawned once for the module)."""
    params = _params(ARCH)
    batch = (pixels(DDP_BATCH, seed=3) / 255.0).astype(np.float32)
    out = tmp_path_factory.mktemp("ddp")
    check = tmp_path_factory.mktemp("check")
    parallel.launch(
        torch_parallel_worker.ddp_step_and_card_check, _cpu_mesh(),
        (ARCH, {"N": N, "M": M}, state_dict_from_jax(ARCH, params), batch,
         LMBDA, str(out)),
        (ARCH, 1, _check_batch(), LMBDA, 2, None, 2, str(check)))
    ranks = [torch.load(out / f"rank{r}.pt") for r in range(MESH)]
    return params, batch, ranks, check


def _check_batch():
    x = torch.from_numpy(pixels(CHECK_BATCH, seed=5) / 255.0).float()
    return x.permute(0, 3, 1, 2)


def _clipped(grads, max_norm=1.0):
    """optax.clip_by_global_norm of the main parameters' gradients (every
    leaf but the quantiles), as the port's step leaves them."""
    main = [g for n, g in grads.items() if not n.endswith("quantiles")]
    norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in main))
    if norm < max_norm:
        return grads
    return {n: g if n.endswith("quantiles") else g / norm * max_norm
            for n, g in grads.items()}


def _close_grads(got, want, bar=1e-3):
    """Every leaf within `bar` of its largest value (test_torch_train's f32
    bar: the frameworks sum in other orders)."""
    assert set(got) == set(want)
    for name, w in want.items():
        scale = w.abs().max().item()
        err = (got[name] - w).abs().max().item()
        assert err <= bar * scale, (name, err, scale)


def test_ddp_step_matches_lmic_tpu_mesh_step(ddp_run, monkeypatch):
    """Two gloo ranks of two rows each against lmic_tpu's step over a
    two-device mesh on the whole batch (params replicated, the batch
    sharded): the losses within rtol 2e-5 (lmic_tpu's bar for its sharded
    step, tests/test_train.py), the all-reduced and clipped gradients at
    the f32 bars; both ranks report the same (global) metrics."""
    params, batch, ranks, _ = ddp_run
    monkeypatch.setattr(jem, "quantize_noise", _jax_noise)
    mesh = jparallel.make_mesh(MESH)
    module = jzoo.make_module(ARCH, 1, N=N, M=M)

    def loss_fn(p, x):
        out = module.apply({"params": p}, x, training=True,
                           rngs={"noise": jax.random.key(0)})
        rd = jtrain.rate_distortion_loss(out, x, LMBDA)
        aux = module.apply({"params": p}, method=type(module).aux_loss)
        return rd["loss"] + aux, {**rd, "aux_loss": aux}

    grads, want = jax.jit(jax.grad(loss_fn, has_aux=True))(
        jparallel.replicate(mesh, jax.tree.map(jnp.asarray, params)),
        jparallel.shard_batch(mesh, jnp.asarray(batch)))
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    for k, v in want.items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], float(v),
                                   rtol=2e-5, err_msg=k)
    want_g = _clipped(state_dict_from_jax(
        ARCH, jax.tree.map(np.asarray, grads)))
    _close_grads(ranks[0]["grads"], want_g)


def test_ddp_step_matches_one_process_step(ddp_run, monkeypatch):
    """The same two ranks against the port's own step in one process on
    the whole batch with the same noise: losses within rtol 2e-5, the
    gradients at the f32 bars."""
    params, batch, ranks, _ = ddp_run
    monkeypatch.setattr(tem, "quantize_noise", rows_of_global_noise(0, 1))
    module = tzoo.make_module(ARCH, 1, N=N, M=M)
    module.load_state_dict(state_dict_from_jax(ARCH, params))
    module = module.to(memory_format=torch.channels_last)
    opt = ttrain.make_optimizer()
    _, metrics = ttrain.make_train_step(module, opt, LMBDA)(
        ttrain.create_train_state(module, opt),
        torch.from_numpy(batch).permute(0, 3, 1, 2))
    for k, v in metrics.items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], float(v),
                                   rtol=2e-5, err_msg=k)
    _close_grads(ranks[0]["grads"],
                 {n: p.grad for n, p in module.named_parameters()})


def test_one_rank_ddp_step_equals_the_plain_step():
    """Two steps under DDP in a one-rank gloo group in this process
    against the plain steps (`crosscheck.data_parallel_steps`, as
    chip_smoke.py and the card test run it with NCCL): metrics, the first
    step's gradients and the parameters after each step bit for bit."""
    from lmic_tpu_torch.utils.crosscheck import data_parallel_steps

    x = torch.from_numpy(pixels((2, 64, 64, 3), seed=4) / 255.0).float()
    args = (ARCH, 1, x.permute(0, 3, 1, 2), LMBDA, "cpu")
    plain = data_parallel_steps(*args, N=N, M=M)
    with parallel.process_group("gloo"):
        ddp = data_parallel_steps(*args, data_parallel=True, N=N, M=M)
    assert ddp["metrics"] == plain["metrics"]
    assert torch.equal(ddp["grads"], plain["grads"])
    assert ddp["param_sha256"] == plain["param_sha256"]
    assert len(set(ddp["param_sha256"])) == 2


def test_two_ranks_of_the_card_check_on_the_cpu(ddp_run):
    """chip_smoke.py's two-rank check (`crosscheck.data_parallel_rank`)
    on two gloo CPU ranks: both report the global metrics and bit-equal
    parameters after each step, within lmic_tpu's loss bar and 1e-5 of the
    gradient (as one vector) of the one-process step on the whole batch;
    the timed steps run, and no device metric is reported off the card."""
    from lmic_tpu_torch.utils.crosscheck import data_parallel_steps

    check = ddp_run[3]
    ranks = [torch.load(check / f"rank{r}.pt", weights_only=False)
             for r in range(MESH)]
    one = data_parallel_steps(ARCH, 1, _check_batch(), LMBDA, "cpu")
    assert ranks[0]["metrics"] == ranks[1]["metrics"]
    assert ranks[0]["param_sha256"] == ranks[1]["param_sha256"]
    for got, want in zip(ranks[0]["metrics"], one["metrics"]):
        assert abs(got["loss"] - want["loss"]) <= 2e-5 * abs(want["loss"])
    assert ((ranks[0]["grads"] - one["grads"]).norm()
            <= 1e-5 * one["grads"].norm())
    for r in ranks:
        assert len(r["step_wall_ms"]) == 2
        assert r["step_device_ms"] is r["peak_gib"] is None


def test_train_cli_devices(tmp_path, capfd):
    """`--devices 2 --device cpu` trains two gloo ranks: rank 0 alone logs
    and writes the checkpoint, which loads; `--devices 1` is the plain
    run, bit for bit (test_torch_train.py holds the refusal of a batch
    that does not split)."""
    root = tmp_path / "ds"
    write_images(root / "train", 8, (40, 40), seed=1)
    write_images(root / "test", 4, (40, 40), seed=2)
    args = ["--arch", "bmshj2018-factorized", "-q", "1", "-d", str(root),
            "--batch-size", "4", "--patch-size", "32", "32",
            "--log-every", "1", "--prefetch", "0", "--seed", "7",
            "--epochs", "1", "--device", "cpu"]
    save = tmp_path / "dp" / "ck.ckpt"
    assert train_cli.main(args + ["--devices", "2",
                                  "--save-path", str(save)]) == 0
    out = capfd.readouterr().out
    assert out.count("epoch 0 it 0: loss=") == 1
    assert out.count("epoch 0 it 1: loss=") == 1
    assert out.count("epoch 0 test loss=") == 1
    assert out.count("epoch 0 done") == 1
    assert save.exists() and not (save.parent / "error.log").exists()
    module = tzoo.make_module("bmshj2018-factorized", 1)
    ckpt.load_train_params(str(save), module)

    plain = [tmp_path / f"{d}" / "ck.ckpt" for d in ("one", "none")]
    train_cli.main(args + ["--devices", "1", "--save-path", str(plain[0])])
    train_cli.main(args + ["--save-path", str(plain[1])])
    a, b = (torch.load(p, weights_only=True) for p in plain)
    for k, v in a["params"].items():
        assert torch.equal(v, b["params"][k]), k



# -- codecs over a mesh ---------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _codecs(arch):
    """lmic_tpu's codec and the port's on the same weights and tables,
    shared by the tests (each shards a `copy.copy`, never these)."""
    params = _params(arch)
    jc = jax_codec(arch, params)
    return jc, carry_tables(jc, port_codec(arch, params)), params


@pytest.mark.parametrize("arch", ["bmshj2018-factorized", "mbt2018-mean",
                                  "mbt2018"])
def test_sharded_codec_matches_one_device_and_lmic_tpu(arch):
    """`shard_codec` over two CPU entries: the strings of the codec on one
    device and of lmic_tpu's codec sharded over a two-device mesh, and the
    single-device codec's pixels (tests/test_train.py's
    TestShardedCodec)."""
    jc, pc, _ = _codecs(arch)
    x = pixels((4, 64, 64, 3), seed=5)
    if arch == "mbt2018":
        x = x.astype(np.float32) / 255.0
    single = pc.compress(x)
    sharded = parallel.shard_codec(copy.copy(pc), _cpu_mesh())
    if arch == "mbt2018":
        assert sharded._fanout_devices == _cpu_mesh().devices
    else:
        fn = getattr(sharded, "_analyze_u8", None) or sharded._enc_u8_packed
        assert fn.devices == _cpu_mesh().devices
    got = sharded.compress(x)
    want = jparallel.shard_codec(copy.copy(jc),
                                 jparallel.make_mesh(MESH)).compress(x)
    assert got["strings"] == single["strings"] == want["strings"]
    u8 = {"u8": True} if x.dtype == np.uint8 else {}
    np.testing.assert_array_equal(
        sharded.decompress(got["strings"], got["shape"], **u8)["x_hat"],
        pc.decompress(single["strings"], single["shape"], **u8)["x_hat"])


def test_sharding_survives_rebuild_and_reshard():
    """A table change rebuilds the fast path with the mesh's placement,
    and a second `shard_codec` moves it onto the new mesh in one build
    (tests/test_train.py:182, 215)."""
    _, pc, _ = _codecs("bmshj2018-factorized")
    x = pixels((4, 64, 64, 3), seed=6)
    codec = parallel.shard_codec(copy.copy(pc), _cpu_mesh(4))
    codec.compress(x)
    codec.update(force=True)  # the module's own tables, not the carried
    single = copy.copy(pc)
    single.update(force=True)
    want = single.compress(x)["strings"]
    assert codec.compress(x)["strings"] == want
    assert len(codec._enc_u8_packed.devices) == 4
    parallel.shard_codec(codec, _cpu_mesh(2))
    assert codec.compress(x)["strings"] == want
    assert codec._enc_u8_packed.devices == _cpu_mesh(2).devices


# -- bundles over a mesh ------------------------------------------------------


@pytest.mark.parametrize("arch", ["bmshj2018-factorized", "mbt2018-mean"])
def test_bundle_serves_over_a_mesh(arch, tmp_path):
    """A bundle exported from a sharded codec records the mesh size and
    serves the live sharded codec's bytes and pixels over a mesh of that
    size (tests/test_aot.py:137-224)."""
    _, pc, _ = _codecs(arch)
    live = parallel.shard_codec(copy.copy(pc), _cpu_mesh())
    x = pixels((4, 64, 64, 3), seed=10)
    want = live.compress(x)
    path = export_serving_bundle(live, str(tmp_path / "b"), x.shape)
    served = load_serving_bundle(path, mesh=_cpu_mesh())
    assert served.bundle_meta["nr_devices"] == MESH
    got = served.compress(x)
    assert got["strings"] == want["strings"] == pc.compress(x)["strings"]
    np.testing.assert_array_equal(
        served.decompress(got["strings"], got["shape"], u8=True)["x_hat"],
        live.decompress(want["strings"], want["shape"], u8=True)["x_hat"])


def test_bundle_mesh_refusals(tmp_path):
    """lmic_tpu's rules: a sharded bundle refuses a mesh of another size,
    an unsharded one any mesh, and `shard_codec` a loaded bundle."""
    _, pc, _ = _codecs("bmshj2018-factorized")
    sharded = str(tmp_path / "sharded")
    export_serving_bundle(parallel.shard_codec(copy.copy(pc), _cpu_mesh()),
                          sharded, (4, 64, 64, 3))
    with pytest.raises(ValueError, match="exported for 2 devices"):
        load_serving_bundle(sharded, mesh=_cpu_mesh(4))
    plain = str(tmp_path / "plain")
    export_serving_bundle(pc, plain, (2, 64, 64, 3))
    with pytest.raises(ValueError, match="unsharded"):
        load_serving_bundle(plain, mesh=_cpu_mesh())
    served = load_serving_bundle(plain, device="cpu")
    with pytest.raises(ValueError, match="frozen at a fixed input"):
        parallel.shard_codec(served, _cpu_mesh())


# -- devices ----------------------------------------------------------------------


def test_device_checks(monkeypatch):
    """A mixed device set is refused; a mesh needs CUDA unless the CPU is
    asked for; the batch splits into contiguous row blocks in order."""
    with pytest.raises(ValueError, match="heterogeneous"):
        parallel.check_homogeneous([torch.device("cuda", 0), "cpu"])
    with pytest.raises(ValueError, match="heterogeneous"):
        parallel.Mesh(["cpu", torch.device("cuda", 0)])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        parallel.make_mesh(2)
    mesh = parallel.make_mesh(3, device="cpu")
    assert mesh.size == 3 and mesh.devices == [torch.device("cpu")] * 3
    x = np.arange(6 * 2).reshape(6, 2)
    blocks = parallel.shard_batch(mesh, x)
    assert [b[:, 0].tolist() for b in blocks] == [[0, 2], [4, 6], [8, 10]]
    with pytest.raises(ValueError, match="does not split"):
        parallel.shard_batch(mesh, x[:4])


def test_rank_noise_rows_add_up_to_the_global_noise():
    """The ranks' rows of the fixed noise (utils/crosscheck.py) and of the
    tests' worker are the rows of one global draw."""
    from lmic_tpu_torch.utils.crosscheck import fixed_noise

    for shape, dim in (((2, 3, 4, 4), 0), ((3, 1, 8), 2)):
        x = torch.zeros(shape)
        with fixed_noise(seed=4):
            whole = tem.quantize_noise(torch.zeros(
                shape[:dim] + (2 * shape[dim],) + shape[dim + 1:]))
        parts = []
        for r in range(2):
            with fixed_noise(seed=4, rank=r, world=2):
                parts.append(tem.quantize_noise(x))
        assert torch.equal(torch.cat(parts, dim), whole)
        worker = [rows_of_global_noise(r, 2)(x.double()) for r in range(2)]
        assert torch.equal(torch.cat(worker, dim),
                           rows_of_global_noise(0, 1)(torch.zeros(
                               whole.shape, dtype=torch.float64)))


def test_rank_seeds():
    assert parallel.rank_seed(7, 0) == 7
    assert len({parallel.rank_seed(7, r) for r in range(4)}) == 4
