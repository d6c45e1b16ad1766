"""The port's user-kernel facility (K4, ``mxnet_tpu_torch.tpu_kernel``)
against the JAX reference, on the CPU.

The seven cases of ``tests/test_tpu_kernel.py`` run twice on the same numpy
inputs: in ``mxnet_tpu`` with Pallas bodies in interpret mode, as that file
runs them, and in ``mxnet_tpu_torch`` with the CUDA bodies of
``chip_smoke.USER_KERNELS`` (one copy, shared with the chip run), which on
CPU tensors take their plain PyTorch versions.  Values and gradients are
compared at rtol 1e-6.  The JAX side registers its ops under names of its
own (``jx_*``), so the global registry ``tests/test_tpu_kernel.py`` expects
is left alone whatever order the files run in.

What a CPU can check of the CUDA route is checked without ``nvcc``:
signature parsing, the generated launcher, a new library for a new body,
the refusals (CPU launch with no plain version, Pallas-only arguments,
dtype and arity mismatches), and that the CPU route counts no launch.
"""
import ctypes

import numpy as np
import pytest
import torch

import mxnet_tpu as jmx
from mxnet_tpu import nd as jnd, autograd as jag

import chip_smoke as cs
import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import nd as tnd, autograd as tag, tpu_kernel as tk
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.ops import _kernels

# six xdist workers share the host's cores: cap torch's intra-op
# threads so that they do not starve one another
torch.set_num_threads(1)

RTOL = 1e-6


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _port_kernel(name, **extra):
    body = cs.USER_KERNELS[name]
    return tk.Kernel(**dict(cs.kernel_args(body), plain=body["plain"],
                            name=name, **extra))


# ---------------------------------------------------------------------------
# the seven cases of tests/test_tpu_kernel.py, both packages
# ---------------------------------------------------------------------------

def test_kernel_launch():
    def axpy(a_ref, x_ref, y_ref, o_ref):
        o_ref[...] = a_ref[...] * x_ref[...] + y_ref[...]

    xv = np.arange(8 * 128, dtype=np.float32).reshape(8, 128)
    j = jmx.tpu_kernel.Kernel(axpy).launch(
        [jnd.full((8, 128), 2.0), jnd.array(xv), jnd.ones((8, 128))],
        out_shape=(8, 128))
    t = _port_kernel("axpy").launch(
        [tnd.full((8, 128), 2.0), tnd.array(xv), tnd.ones((8, 128))],
        out_shape=(8, 128))
    assert isinstance(t, tnd.NDArray) and t.context == tmx.cpu()
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=RTOL)
    np.testing.assert_allclose(t.asnumpy(), 2.0 * xv + 1.0, rtol=RTOL)


def test_kernel_decorator_and_call():
    @jmx.tpu_kernel.kernel()
    def double(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 2.0

    body = cs.USER_KERNELS["double"]
    tdouble = tk.kernel("double", **cs.kernel_args(body))(body["plain"])
    assert isinstance(tdouble, tk.Kernel) and tdouble.name == "double"
    xv = np.random.RandomState(0).randn(4, 128).astype(np.float32)
    j = double(jnd.array(xv), out_shape=(4, 128))
    t = tdouble(tnd.array(xv), out_shape=(4, 128))
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=RTOL)
    with pytest.raises(MXNetError, match="out_shape"):
        tdouble(tnd.array(xv))


def test_kernel_gridded():
    import jax.experimental.pallas as pl

    @jmx.tpu_kernel.kernel(grid=(2,),
                           in_specs=[pl.BlockSpec((4, 128),
                                                  lambda i: (i, 0))],
                           out_specs=pl.BlockSpec((4, 128),
                                                  lambda i: (i, 0)))
    def relu_blocked(x_ref, o_ref):
        o_ref[...] = x_ref[...].clip(0.0)

    k = _port_kernel("relu_blocked")
    # the CUDA launch dims: one block of 256 threads per row
    assert k.grid((8, 128)) == (8,) and k.block == (256,)
    xv = np.random.RandomState(1).randn(8, 128).astype(np.float32)
    j = relu_blocked(jnd.array(xv), out_shape=(8, 128))
    t = k(tnd.array(xv), out_shape=(8, 128))
    np.testing.assert_allclose(t.asnumpy(), j.asnumpy(), rtol=RTOL)
    np.testing.assert_allclose(t.asnumpy(), np.maximum(xv, 0), rtol=RTOL)


def test_registered_op_with_grad():
    @jmx.tpu_kernel.register("jx_pallas_square", out_shape_fn=lambda x: x,
                             grad=lambda cts, x: (cts[0] * 2.0 * x,))
    def square_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] * x_ref[...]

    cs.register_body("square", op_name="pallas_square")
    xv = np.array([1.0, -2.0, 3.0], np.float32)
    got = {}
    for name, nd, ag, op in (("jax", jnd, jag, "jx_pallas_square"),
                             ("port", tnd, tag, "pallas_square")):
        x = nd.array(xv)
        out = getattr(nd, op)(x)
        x.attach_grad()
        with ag.record():
            y = getattr(nd, op)(x)
        y.backward()
        got[name] = (out.asnumpy(), x.grad.asnumpy())
    for j, t in zip(got["jax"], got["port"]):
        np.testing.assert_allclose(t, j, rtol=RTOL)
    np.testing.assert_allclose(got["port"][1], 2 * xv, rtol=RTOL)


def test_registered_op_in_hybridize():
    @jmx.tpu_kernel.register("jx_pallas_scale3", out_shape_fn=lambda x: x,
                             grad=lambda cts, x: (cts[0] * 3.0,))
    def scale3(x_ref, o_ref):
        o_ref[...] = x_ref[...] * 3.0

    cs.register_body("scale3", op_name="pallas_scale3")

    class JNet(jmx.gluon.HybridBlock):
        def forward(self, x):
            return jnd.jx_pallas_scale3(x)

    class TNet(tmx.gluon.HybridBlock):
        def forward(self, x):
            return tnd.pallas_scale3(x)

    xv = np.random.RandomState(2).randn(2, 5).astype(np.float32)
    got = {}
    for name, net, nd, ag in (("jax", JNet(), jnd, jag),
                              ("port", TNet(), tnd, tag)):
        net.hybridize()
        x = nd.array(xv)
        x.attach_grad()
        with ag.record():
            y = net(x)
        y.backward()
        got[name] = (y.asnumpy(), x.grad.asnumpy())
    for j, t in zip(got["jax"], got["port"]):
        np.testing.assert_allclose(t, j, rtol=RTOL)
    np.testing.assert_allclose(got["port"][1], np.full_like(xv, 3.0))


def test_reregistration_evicts_jit_cache():
    def jmake(mult):
        @jmx.tpu_kernel.register("jx_pallas_mul_iter",
                                 out_shape_fn=lambda x: x)
        def mul_kernel(x_ref, o_ref):
            o_ref[...] = x_ref[...] * mult
        return mul_kernel

    def tmake(mult):
        return cs.register_body("mul", cs.mul_body(mult),
                                op_name="pallas_mul_iter")

    xv = np.array([1.0, 2.0], np.float32)
    libraries = []
    for mult, want in ((2.0, [2.0, 4.0]), (5.0, [5.0, 10.0])):
        jmake(mult)
        libraries.append(tmake(mult).library.library_path())
        j = jnd.jx_pallas_mul_iter(jnd.array(xv)).asnumpy()
        t = tnd.pallas_mul_iter(tnd.array(xv)).asnumpy()
        np.testing.assert_allclose(t, j, rtol=RTOL)
        np.testing.assert_allclose(t, want)
    # the new body is a new source, hence a new library to build
    assert libraries[0] != libraries[1]


def test_nondiff_registered_op_refuses_grad():
    @jmx.tpu_kernel.register("jx_pallas_sign_nd", out_shape_fn=lambda x: x)
    def sign_kernel(x_ref, o_ref):
        o_ref[...] = (x_ref[...] > 0).astype(x_ref[...].dtype)

    cs.register_body("sign", op_name="pallas_sign_nd")
    xv = np.array([1.0, -1.0], np.float32)
    j = jnd.jx_pallas_sign_nd(jnd.array(xv)).asnumpy()
    t = tnd.pallas_sign_nd(tnd.array(xv)).asnumpy()
    np.testing.assert_allclose(t, j)
    np.testing.assert_allclose(t, [1.0, 0.0])
    assert not tmx.ops.registry.get_op("pallas_sign_nd").differentiable
    x = tnd.array(xv)
    x.attach_grad()
    with tag.record():
        y = tnd.pallas_sign_nd(x)
    assert not y.data.requires_grad
    with pytest.raises(MXNetError, match="not computed while autograd"):
        y.backward()


# ---------------------------------------------------------------------------
# the bodies, in both dtypes of the card, through their plain versions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(cs.USER_KERNELS))
def test_every_body_registers_and_matches_its_plain_version(name):
    body = cs.USER_KERNELS[name]
    k = cs.register_body(name, op_name="tk_" + name)
    n_in = 3 if name == "axpy" else 1
    rng = np.random.RandomState(3)
    xs = [rng.randn(16, 96).astype(np.float32) for _ in range(n_in)]
    want = body["plain"](*[torch.from_numpy(x) for x in xs]).numpy()
    out = getattr(tnd, "tk_" + name)(*[tnd.array(x) for x in xs])
    np.testing.assert_allclose(out.asnumpy(), want, rtol=RTOL)
    launched = k.launch([tnd.array(x) for x in xs], out_shape=(16, 96))
    np.testing.assert_array_equal(launched.asnumpy(), out.asnumpy())
    assert set(k._variants) == {torch.float32, torch.bfloat16}


# ---------------------------------------------------------------------------
# the CUDA route, as far as a machine without nvcc can check it
# ---------------------------------------------------------------------------

def test_signature_parsing_into_ctypes():
    params = tk.parse_signature(
        "const float* __restrict__ a, const __nv_bfloat16 *x, half* o, "
        "int n, long long m, float alpha")
    assert [(p.name, p.ctype, p.pointer) for p in params] == [
        ("a", "float", True), ("x", "__nv_bfloat16", True),
        ("o", "half", True), ("n", "int", False),
        ("m", "long long", False), ("alpha", "float", False)]
    assert [tk.POINTER_DTYPES[p.ctype] for p in params[:3]] == [
        torch.float32, torch.bfloat16, torch.float16]
    assert [tk.SCALAR_CTYPES[p.ctype] for p in params[3:]] == [
        ctypes.c_int, ctypes.c_longlong, ctypes.c_float]


@pytest.mark.parametrize("bad, match", [
    ("double* x", "supported are"),
    ("const float* x, unsigned n", "supported are"),
    ("int n, float* x", "before every scalar"),
    ("float& x", "references"),
    ("float** x", "cannot read"),
    ("x", "cannot read"),
])
def test_signature_refusals(bad, match):
    with pytest.raises(MXNetError, match=match):
        tk.parse_signature(bad)


def test_generated_launcher_text():
    k = _port_kernel("axpy")
    src = k.source
    assert src.startswith(tk.PRELUDE)
    for include in ("cuda_runtime.h", "cuda_bf16.h", "cuda_fp16.h"):
        assert "#include <%s>" % include in src
    assert cs.USER_KERNELS["axpy"]["source"].strip() in src
    for i, entry in enumerate(("axpy<float>", "axpy<__nv_bfloat16>")):
        assert 'extern "C" int mx_user_launch_%d(' % i in src
        assert "(const void*)(&%s)" % entry in src
    assert src.count("cudaLaunchKernel(") == 2
    assert src.count("cudaGetLastError()") == 2
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in src
    assert 'extern "C" const char* mx_cuda_error_string' in src
    # the signature with T substituted, per variant
    assert [p.ctype for p in k._variants[torch.bfloat16].params[:4]] == \
        ["__nv_bfloat16"] * 4
    assert [p.ctype for p in k._variants[torch.float32].params][-1] == \
        "long long"
    plain = tk.generate_source("__global__ void f(float* o) {}", ["f"])
    assert "(const void*)(&f)" in plain and "mx_user_launch_1" not in plain


def test_library_is_keyed_by_the_source_not_the_name():
    a = cs.register_body("mul", cs.mul_body(2.0), op_name="tk_lib_a")
    b = cs.register_body("mul", cs.mul_body(2.0), op_name="tk_lib_b")
    c = cs.register_body("mul", cs.mul_body(5.0), op_name="tk_lib_a")
    path = a.library.library_path()
    assert path.parent == _kernels.BUILD_DIR and path.suffix == ".so"
    assert b.library.library_path().name.split("-")[1] == \
        path.name.split("-")[1]
    assert c.library.library_path() != path
    assert c.library.source.suffix == ".cu"
    assert not c.library.source.exists()     # nothing built at register


def test_cpu_launch_without_plain_raises_and_names_the_kernel():
    body = cs.USER_KERNELS["double"]
    k = tk.Kernel(**dict(cs.kernel_args(body), name="no_plain_double"))
    with pytest.raises(MXNetError, match="no_plain_double.*no plain="):
        k.launch([tnd.ones((4, 4))], out_shape=(4, 4))


@pytest.mark.parametrize("arg", ["in_specs", "out_specs", "interpret"])
def test_pallas_arguments_raise(arg):
    body = cs.USER_KERNELS["double"]
    with pytest.raises(MXNetError, match=arg + "= is a Pallas argument"):
        tk.Kernel(**dict(cs.kernel_args(body), **{arg: True}))
    with pytest.raises(MXNetError, match=arg):
        tk.kernel(**dict(cs.kernel_args(body), **{arg: True}))(body["plain"])


def test_plain_version_must_return_the_asked_shape():
    body = cs.USER_KERNELS["double"]
    k = tk.Kernel(**dict(cs.kernel_args(body), plain=lambda x: x[:2]))
    with pytest.raises(MXNetError, match="plain version returned"):
        k.launch([tnd.ones((4, 4))], out_shape=(4, 4))


def test_launch_arguments_are_arrays():
    k = _port_kernel("double")
    with pytest.raises(MXNetError, match="scalar parameters come from"):
        k.launch([tnd.ones((4, 4)), 16], out_shape=(4, 4))


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("case, match", [
    ("dtype", "input 0 \\(x\\) is torch.float16"),
    ("arity", "2 inputs \\+ 1 outputs, but the signature has 2 pointers"),
    ("out_dtype", "output o asked as torch.bfloat16"),
    ("scalars", "2 scalar values for 1 scalar parameters"),
    ("int_range", "does not fit an int"),
    ("grid", "grid \\(0, 1\\)"),
])
def test_cuda_route_checks_before_any_launch(case, match):
    """The CUDA route's checks, run on meta tensors (shape and dtype only):
    each refuses before a library is built or a kernel launched."""
    body = cs.USER_KERNELS["double"]
    kw = {}
    vals, structs = [_meta(4, 4)], [((4, 4), torch.float32)]
    if case == "dtype":
        vals = [_meta(4, 4, dtype=torch.float16)]
        kw = dict(dtypes=None, signature="const float* x, float* o, "
                                         "long long n")
    elif case == "arity":
        vals = [_meta(4, 4), _meta(4, 4)]
    elif case == "out_dtype":
        structs = [((4, 4), torch.bfloat16)]
    elif case == "scalars":
        kw["scalars"] = lambda x, o: (1, 2)
    elif case == "int_range":
        kw = dict(signature="const T* x, T* o, int n",
                  scalars=lambda x, o: (2 ** 31,))
    elif case == "grid":
        kw["grid"] = (0, 1)
    k = tk.Kernel(**dict(cs.kernel_args(body), **kw))
    with pytest.raises(MXNetError, match=match):
        k._run_cuda(vals, structs, torch.device("meta"))
    assert k.library._lib is None


def test_a_card_launch_without_nvcc_raises_never_falls_back(monkeypatch,
                                                             tmp_path):
    """Past its checks the CUDA route builds the library; without nvcc
    that raises, and the plain version is not taken instead."""
    def no_nvcc():
        raise MXNetError("nvcc not found (stand-in for a machine without "
                         "the CUDA toolkit)")

    monkeypatch.setattr(_kernels, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_kernels, "nvcc_path", no_nvcc)
    body = cs.USER_KERNELS["double"]
    calls = []
    k = tk.Kernel(**dict(cs.kernel_args(body),
                         plain=lambda x: calls.append(x) or x * 2.0))
    with pytest.raises(MXNetError, match="nvcc not found"):
        k._run_cuda([_meta(4, 4)], [((4, 4), torch.float32)],
                    torch.device("meta"))
    assert not calls
    with pytest.raises(MXNetError, match="takes CUDA tensors"):
        k.run([_meta(4, 4)], [((4, 4), torch.float32)])


def test_the_cpu_route_counts_no_launch():
    k = cs.register_body("square", op_name="tk_counted_square")
    before = _kernels.launch_counts()
    x = tnd.array(np.ones((3,), np.float32))
    x.attach_grad()
    with tag.record():
        y = tnd.tk_counted_square(x)
    y.backward()
    k.launch([x], out_shape=(3,))
    assert _kernels.launch_counts() == before
    assert k.counter not in before
    assert k.library.launches == {k.counter: 0}


def test_out_shape_fn_gets_meta_avals_and_may_give_several_outputs():
    seen = []
    body = cs.USER_KERNELS["double"]

    def out_shape_fn(x):
        seen.append((x.device.type, tuple(x.shape), x.dtype))
        return [x, x]

    tk.register("tk_two_outputs", out_shape_fn=out_shape_fn,
                **dict(cs.kernel_args(body),
                       signature="const T* x, T* o, T* p, long long n"))(
        lambda x: (x * 2.0, x * 3.0))
    a, b = tnd.tk_two_outputs(tnd.array(np.ones((2, 3), np.float32)))
    assert seen == [("meta", (2, 3), torch.float32)]
    np.testing.assert_array_equal(a.asnumpy(), np.full((2, 3), 2.0))
    np.testing.assert_array_equal(b.asnumpy(), np.full((2, 3), 3.0))
