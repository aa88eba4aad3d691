"""lmic_tpu_torch.ops against lmic_tpu.ops: lower_bound, the non-negative
reparametrization and STE rounding, forward and gradients against
jax.grad; the CDF quantizer integer-equal on random pmfs."""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lmic_tpu.ops import cdf as jcdf
from lmic_tpu.ops import math as jmath
from lmic_tpu_torch.ops import cdf as tcdf
from lmic_tpu_torch.ops import math as tmath

torch.set_num_threads(2)


def _vjp_jax(fn, x, g):
    y, vjp = jax.vjp(fn, jnp.asarray(x))
    return np.asarray(y), np.asarray(vjp(jnp.asarray(g))[0])


def _vjp_torch(fn, x, g):
    xt = torch.tensor(x, requires_grad=True)
    y = fn(xt)
    y.backward(torch.tensor(g))
    return y.detach().numpy(), xt.grad.numpy()


def _data(seed, n=4096):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, n).astype(np.float32)
    g = rng.normal(0, 1, n).astype(np.float32)
    return x, g


@pytest.mark.parametrize("seed", [0, 1])
def test_lower_bound_forward_and_gradient(seed):
    # exact: max and the pass-through mask are the same elementwise ops
    x, g = _data(seed)
    bound = np.float32(0.1)
    want = _vjp_jax(lambda v: jmath.lower_bound(v, jnp.float32(bound)), x, g)
    got = _vjp_torch(lambda v: tmath.lower_bound(v, float(bound)), x, g)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    got = _vjp_torch(tmath.LowerBound(bound), x, g)
    np.testing.assert_array_equal(got[1], want[1])


@pytest.mark.parametrize("minimum", [0.0, 1e-6])
def test_non_negative_parametrizer(minimum):
    # a square and a subtraction of the pedestal in f32: equal to 1 ulp
    x, g = _data(2)
    jp = jmath.NonNegativeParametrizer(minimum=minimum)
    tp = tmath.NonNegativeParametrizer(minimum=minimum)
    want = _vjp_jax(jp, x, g)
    got = _vjp_torch(tp, x, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-12)
    init = np.abs(x) * 0.1
    np.testing.assert_allclose(
        tp.init(torch.from_numpy(init)).numpy(),
        np.asarray(jp.init(jnp.asarray(init))), rtol=1e-6,
    )


def test_ste_round_forward_and_gradient():
    # half-to-even rounding on both sides, identity gradient: exact
    x, g = _data(3)
    x[:8] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, -3.5]
    want = _vjp_jax(jmath.ste_round, x, g)
    got = _vjp_torch(tmath.ste_round, x, g)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_from_amp_upcasts_only():
    for dt in (torch.bfloat16, torch.float16):
        assert tmath.from_amp(torch.ones(2, dtype=dt)).dtype == torch.float32
    for dt in (torch.float32, torch.float64):
        assert tmath.from_amp(torch.ones(2, dtype=dt)).dtype == dt


@pytest.mark.parametrize("seed", range(4))
def test_quantized_cdf_equals_lmic_tpu(seed):
    rng = np.random.default_rng(seed)
    rows, L = 12, 40
    pmf = rng.random((rows, L)).astype(np.float32) ** 4  # sparse-ish tails
    pmf[:, ::7] = 0.0  # zero-width intervals force the repair loop
    pmf /= pmf.sum(1, keepdims=True)
    tail = rng.random(rows).astype(np.float32) * 1e-6
    length = rng.integers(5, L + 1, rows)
    want = jcdf.batched_pmf_to_quantized_cdf(pmf, tail, length, L)
    got = tcdf.batched_pmf_to_quantized_cdf(pmf, tail, length, L)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        tcdf.pmf_to_quantized_cdf(pmf[0]), jcdf.pmf_to_quantized_cdf(pmf[0])
    )


def test_build_key_hashes_the_shared_cuda_headers(tmp_path, monkeypatch):
    """An edited csrc/*.cuh gives every CUDA source a new library path, so a
    library built from the old header is never loaded; a C++ source's path
    does not depend on the CUDA headers."""
    import os

    from lmic_tpu_torch.ops import _build

    assert os.path.join(_build.CSRC, "gdn_hopper.cuh") in _build._inputs(
        "gdn_fwd.cu")
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    (tmp_path / "r.cc").write_text("int f() { return 0; }\n")
    monkeypatch.setattr(_build, "CSRC", str(tmp_path))
    monkeypatch.setattr(_build, "_nvcc", lambda: "nvcc")  # none on the CPU
    cu, cc = _build.library_path("k.cu"), _build.library_path("r.cc")
    assert cu.startswith(_build.BUILD_DIR) and cu != cc
    (tmp_path / "h.cuh").write_text("// two\n")
    assert _build.library_path("k.cu") != cu
    assert _build.library_path("r.cc") == cc


# C parameter types -> the ctypes that ops/gdn.py binds them to
_CTYPES = {"const void *": ctypes.c_void_p, "void *": ctypes.c_void_p,
           "int64_t": ctypes.c_int64, "int": ctypes.c_int}
# C return types -> the restype that ops/gdn.py gives them
_RESTYPES = {"const char *": ctypes.c_char_p, "int64_t": ctypes.c_int64,
             "int": ctypes.c_int}


def _extern_c(path):
    """{name: (return type, [parameter types])} of each function defined in
    the `extern "C"` block of the CUDA source at `path`."""
    import re

    with open(path) as f:
        text = f.read()
    block = re.sub(r"//[^\n]*", "", text[text.index('extern "C" {'):])
    found = {}
    for m in re.finditer(r"^((?:const )?\w+ \*?)(lmic_\w+)\(([^)]*)\) \{",
                         block, re.M):
        params = [p.strip() for p in m.group(3).split(",") if p.strip()]
        found[m.group(2)] = (m.group(1).strip(), [
            re.sub(r"\s*\w+$", "", p).replace("void*", "void *")
            for p in params])
    return found


@pytest.mark.parametrize("source", ["gdn_fwd.cu", "gdn_bwd.cu"])
def test_gdn_signatures_match_the_c_abi(source):
    """ops/gdn.py's ctypes bindings (`_SIGNATURES`, and the restype `_load`
    gives each name) declare every entry point of the CUDA source's C ABI
    with its arguments in order: a pointer bound as a 32-bit int, or a
    missing argument, would only show on the card."""
    import os

    from lmic_tpu_torch.ops import _build, gdn

    defined = _extern_c(os.path.join(_build.CSRC, source))
    bound = gdn._SIGNATURES[source]
    assert sorted(defined) == sorted(bound)
    for name, (ret, params) in defined.items():
        assert _RESTYPES[ret] == gdn._restype(name), name
        assert [_CTYPES[p] for p in params] == bound[name], name


def _global_kernels(source):
    """The names of the `__global__` kernels of the CUDA source `source`."""
    import os
    import re

    from lmic_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, source)) as f:
        text = re.sub(r"//[^\n]*", "", f.read())
    return set(re.findall(
        r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(",
        text))


@pytest.mark.parametrize("source", ["gdn_fwd.cu", "gdn_bwd.cu"])
def test_launch_counts_name_every_kernel(source):
    """The C ABI's per-kernel launch counts (`kKernelNames`, read through
    `lmic_gdn_*_kernel_name`) name each `__global__` kernel of the source
    once, so `gdn.kernel_launches` cannot miss a route; and each
    kernel's launcher returns through `counted` for it, once."""
    import os
    import re

    from lmic_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, source)) as f:
        text = f.read()
    table = re.search(r"kKernelNames\[kKernels\] = \{([^}]*)\}", text)
    names = re.findall(r'"(\w+)"', table.group(1))
    assert len(names) == len(set(names))
    assert set(names) == _global_kernels(source)
    enum = re.search(r"enum Kernel \{([^}]*)\}", text).group(1)
    ids = [e.strip() for e in enum.split(",") if e.strip()]
    assert ids[-1] == "kKernels" and len(ids) - 1 == len(names)
    for k in ids[:-1]:
        assert text.count(f"return counted({k});") == 1, k


def test_kernel_launches_reads_each_loaded_library(monkeypatch):
    """`gdn.kernel_launches` gives {kernel name: launches} of each GDN
    library loaded, by index until the C ABI's name is null, and leaves
    out a library not loaded yet or one without the counts."""
    from lmic_tpu_torch.ops import gdn

    class Lib:
        def __init__(self, names, counts):
            self.names, self.counts = names, counts

        def name(self, k):
            return self.names[k].encode() if k < len(self.names) else None

        def launches(self, k):
            return self.counts[k]

    fwd = Lib(["gdn_fwd_kernel", "gdn_fwd_wide_kernel"], [3, 5])
    fwd.lmic_gdn_fwd_kernel_name = fwd.name
    fwd.lmic_gdn_fwd_kernel_launches = fwd.launches
    monkeypatch.setattr(gdn, "_libs", {"gdn_fwd.cu": fwd})
    assert gdn.kernel_launches() == {"gdn_fwd_kernel": 3,
                                     "gdn_fwd_wide_kernel": 5}
    monkeypatch.setattr(gdn, "_libs", {"gdn_bwd.cu": object()})
    assert gdn.kernel_launches() == {}


def _smoke_kernel_lists():
    """{name: tuple of str} of the kernel lists chip_smoke.py assigns at its
    top level, read from its source (nothing of it is imported)."""
    import ast
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    lists = {}

    def value(node):  # a tuple of strings, a list named before, or a sum
        if isinstance(node, ast.Tuple) and all(
                isinstance(e, ast.Constant) and isinstance(e.value, str)
                for e in node.elts):
            return tuple(e.value for e in node.elts)
        if isinstance(node, ast.Name):
            return lists.get(node.id)
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            a, b = value(node.left), value(node.right)
            return None if a is None or b is None else a + b
        return None

    for node in tree.body:
        if (isinstance(node, ast.Assign) and len(node.targets) == 1
                and isinstance(node.targets[0], ast.Name)):
            found = value(node.value)
            if found is not None:
                lists[node.targets[0].id] = found
    return lists


@pytest.mark.parametrize("source", ["gdn_fwd.cu", "gdn_bwd.cu"])
def test_every_gdn_kernel_is_in_one_smoke_list(source):
    """Each `__global__` kernel of the CUDA source is named in exactly one
    of chip_smoke.py's MMA_KERNELS (must run on the tensor cores) and
    FP32_KERNELS (must not), so the card's SASS check covers it and cannot
    pass over a new kernel; the no-spill list names kernels of the
    sources."""
    kernels = _global_kernels(source)
    assert kernels and all(k.startswith(source[:-3] + "_") for k in kernels)
    lists = _smoke_kernel_lists()
    mma, fp32 = set(lists["MMA_KERNELS"]), set(lists["FP32_KERNELS"])
    for kernel in kernels:
        assert (kernel in mma) + (kernel in fp32) == 1, kernel
    ours = {k for k in mma | fp32 if k.startswith(source[:-3] + "_")}
    assert ours == kernels  # no stale name either
    for name in lists["NO_SPILL_KERNELS"]:
        assert name in mma | fp32, name


def test_package_data_ships_every_native_source():
    """An installed wheel builds the kernels from the package's own csrc/:
    every file there (the .cu sources, the .cuh headers they include and
    `_build._inputs` hashes, the .cc coder) matches a pattern of
    pyproject.toml's package data for `lmic_tpu_torch.csrc`."""
    import fnmatch
    import os
    import tomllib

    from lmic_tpu_torch.ops import _build

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, "pyproject.toml"), "rb") as f:
        data = tomllib.load(f)["tool"]["setuptools"]["package-data"]
    patterns = data["lmic_tpu_torch.csrc"]
    files = sorted(os.listdir(_build.CSRC))
    hashed = {os.path.basename(p) for p in _build._inputs("gdn_fwd.cu")}
    assert any(f.endswith(".cuh") for f in hashed) and hashed <= set(files)
    missing = [f for f in files
               if not any(fnmatch.fnmatch(f, p) for p in patterns)]
    assert not missing, missing
