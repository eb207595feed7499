"""``repro_torch::linear_scan`` (``kernels/linear_scan.py``), the linear
recurrence of the RG-LRU and the sLSTM, on the CPU.

* Both custom ops pass ``torch.library.opcheck``; the op passes
  ``gradcheck`` in float64 (its CPU implementation takes any float dtype).
* In f32 the forward equals the per-position loop the port ran before
  (``h = a[:, t] * h + b[:, t]``) bit for bit, and the backward equals
  autograd through that loop bit for bit: each step is one rounded product
  and one rounded sum in both, and the zeros autograd adds are exact.
  The same holds for whole RG-LRU and sLSTM blocks.
* The RG-LRU's ``h0`` path (folded into the first input) against the
  reference within its scan tolerance, 1e-4.
* A dispatch mode sees one op forward and one backward; fake tensors give
  shapes and launch nothing.
* The wrapper refuses other dtypes, shapes, layouts and devices, and the
  CUDA wrappers refuse CPU tensors: no fallback.
* The launch plan (``scan_plan``): every (b, d) channel walked by exactly
  one thread, a grid within the launch limits, shared memory within the
  H100's opt-in limit a block, and a fake ``cuda`` launch reports the
  plan's bytes.

The kernel itself is held against these plain versions on the card
(``tests/test_torch_cuda.py``, marker ``gpu``, and ``chip_smoke.py``).
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro.models import rglru as JRG
from repro.models.config import ModelConfig as JModelConfig
from repro_torch import configs
from repro_torch.kernels import _checks, ops
from repro_torch.kernels.linear_scan import (BARRIERS, CHUNK, RING_PAD,
                                             SHORT_T, SHORT_T_BACKWARD,
                                             linear_scan,
                                             linear_scan_backward_cuda,
                                             linear_scan_backward_plain,
                                             linear_scan_cuda,
                                             linear_scan_plain,
                                             plan_channels, scan_plan)
from repro_torch.kernels.ref import linear_scan_loop as loop
from repro_torch.models import rglru as RG
from repro_torch.models import xlstm as XL

SCAN_TOL = dict(rtol=1e-4, atol=1e-4)
LENGTHS = [1, 7, 128]


def inputs(t, b=3, d=5, seed=0, dtype=np.float32):
    """Decays in (0, 1) and inputs of either sign, as the RG-LRU and the
    sLSTM make them, and an upstream gradient."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.05, 0.999, size=(b, t, d)).astype(dtype)
    x = rng.normal(size=(b, t, d)).astype(dtype)
    g = rng.normal(size=(b, t, d)).astype(dtype)
    return torch.from_numpy(a), torch.from_numpy(x), torch.from_numpy(g)


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_opcheck(direction):
    a, b, g = inputs(9)
    if direction == "forward":
        torch.library.opcheck(torch.ops.repro_torch.linear_scan.default,
                              (a.requires_grad_(), b.requires_grad_()))
    else:
        h = linear_scan_plain(a, b)
        torch.library.opcheck(
            torch.ops.repro_torch.linear_scan_backward.default, (a, h, g))


@pytest.mark.parametrize("t", [1, 7])
def test_gradcheck_float64(t):
    a, b, _ = inputs(t, dtype=np.float64)
    assert torch.autograd.gradcheck(torch.ops.repro_torch.linear_scan,
                                    (a.requires_grad_(), b.requires_grad_()))


@pytest.mark.parametrize("t", LENGTHS)
def test_forward_equals_the_loop_bit_for_bit(t):
    a, b, _ = inputs(t, seed=t)
    assert torch.equal(linear_scan(a, b), loop(a, b))
    assert torch.equal(linear_scan_plain(a, b), loop(a, b))


@pytest.mark.parametrize("t", LENGTHS)
def test_backward_equals_autograd_through_the_loop_bit_for_bit(t):
    a, b, g = inputs(t, seed=t + 1)
    got = torch.autograd.grad(linear_scan(a.requires_grad_(),
                                          b.requires_grad_()), (a, b), g)
    want = torch.autograd.grad(loop(a, b), (a, b), g)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    plain = linear_scan_backward_plain(a, linear_scan_plain(a, b), g)
    assert torch.equal(plain[0], want[0]) and torch.equal(plain[1], want[1])


def _rglru_params(d=16, seed=4):
    jc = JModelConfig(name="t", n_layers=1, d_model=d, n_heads=2, n_kv=2,
                      d_ff=0, vocab=8, pattern=("rglru",))
    tree = JRG.init_rglru(jax.random.key(seed), jc, jnp.float32)
    host = {k: np.asarray(v) for k, v in tree.items()}
    return ({k: jnp.asarray(v) for k, v in host.items()},
            {k: torch.from_numpy(v.copy()) for k, v in host.items()})


def test_rglru_h0_path():
    """``rglru`` with a carried state: against the reference within 1e-4,
    and equal to the loop-based recurrence bit for bit (values and the
    gradient of h0)."""
    jp, tp = _rglru_params()
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, 10, 16)).astype(np.float32)
    h0 = rng.normal(size=(2, 16)).astype(np.float32)
    jy, jh = JRG.rglru(jp, jnp.asarray(x), jnp.asarray(h0))
    th0 = torch.from_numpy(h0).requires_grad_()
    ty, th = RG.rglru(tp, torch.from_numpy(x), th0)
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(jy),
                               **SCAN_TOL)
    np.testing.assert_allclose(th.detach().numpy(), np.asarray(jh),
                               **SCAN_TOL)
    (g_op,) = torch.autograd.grad(ty.sum(), th0)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(RG, "_scan_linear_recurrence", loop)
        th0.grad = None
        ly, lh = RG.rglru(tp, torch.from_numpy(x), th0)
        (g_loop,) = torch.autograd.grad(ly.sum(), th0)
    assert torch.equal(ty, ly) and torch.equal(th, lh)
    assert torch.equal(g_op, g_loop)


def _block(kind, seed=3):
    cfg = configs.get_smoke("recurrentgemma_2b" if kind == "rglru"
                            else "xlstm_125m")
    gen = torch.Generator().manual_seed(seed)
    init = RG.init_rglru if kind == "rglru" else XL.init_slstm
    fn = RG.rglru_block if kind == "rglru" else XL.slstm_block
    p = {k: v.requires_grad_() for k, v in
         init(gen, cfg, torch.float32, "cpu").items()}
    x = torch.randn((2, 33, cfg.d_model), generator=gen).requires_grad_()
    return cfg, p, x, fn


@pytest.mark.parametrize("kind", ["rglru", "slstm"])
def test_block_gradients_equal_the_loop_bit_for_bit(kind, monkeypatch):
    """A whole block's output and every gradient, through the op and
    through the loop, bit for bit."""
    cfg, p, x, fn = _block(kind)
    leaves = [x, *p.values()]

    def run():
        out, _ = fn(p, x, None, cfg)
        g = torch.autograd.grad((out * out).sum(), leaves)
        return out, g

    out, grads = run()
    monkeypatch.setattr(RG, "_scan_linear_recurrence", loop)
    monkeypatch.setattr(XL, "_scan_linear_recurrence", loop)
    out_loop, grads_loop = run()
    assert torch.equal(out, out_loop)
    for name, a, b in zip(["x", *p], grads, grads_loop):
        assert torch.equal(a, b), name


class _Ops(TorchDispatchMode):
    """The ops dispatched that are not views (``launch/analysis.count``
    counts the same)."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view:
            self.names.append(str(func.overloadpacket))
        return func(*args, **(kwargs or {}))


def test_one_op_each_way():
    a, b, g = inputs(64)
    a.requires_grad_()
    with _Ops() as mode:
        h = linear_scan(a, b)
    assert mode.names == ["repro_torch.linear_scan"]
    with _Ops() as mode:
        torch.autograd.grad(h, a, g)
    assert mode.names == ["repro_torch.linear_scan_backward"]


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_fake_tensors_give_shapes_and_launch_nothing(device, monkeypatch):
    """On fake tensors (the dry run's) both ops return their shapes; a fake
    ``cuda`` operand reports the launch the card would make to the
    listener, with its plan's shared-memory bytes, and nothing counts as
    launched.  (A fake ``cuda`` tensor
    that requires grad aborts autograd in a CPU-only build, so the
    backward op is called directly there.)"""
    heard = []
    monkeypatch.setattr(_checks, "listener",
                        lambda kernel, modes, smem: heard.append(
                            (kernel, smem)))
    ops.reset_launch_counts()
    with FakeTensorMode(allow_non_fake_inputs=True):
        a = torch.empty((2, 4096, 8), device=device,
                        requires_grad=device == "cpu")
        b = torch.empty((2, 4096, 8), device=device)
        h = linear_scan(a, b)
        g = torch.empty_like(h)
        if device == "cpu":
            (da,) = torch.autograd.grad(h, a, g)
        else:
            da, _ = torch.ops.repro_torch.linear_scan_backward(a, h, g)
    assert h.shape == da.shape == (2, 4096, 8)
    assert h.device.type == da.device.type == device
    smem = (scan_plan((2, 4096, 8)).smem,
            scan_plan((2, 4096, 8), backward=True).smem)
    assert smem[0] > 0 and smem[1] > 0
    assert heard == ([("linear_scan", smem[0]),
                      ("linear_scan_backward", smem[1])]
                     if device == "cuda" else [])
    assert ops.launch_counts()["linear_scan"] == 0
    assert ops.launch_counts()["linear_scan_backward"] == 0


def test_cpu_tensors_take_the_plain_version():
    a, b, _ = inputs(5)
    ops.reset_launch_counts()
    linear_scan(a.requires_grad_(), b).sum().backward()
    assert ops.launch_counts()["linear_scan"] == 0
    assert ops.launch_counts()["linear_scan_backward"] == 0


@pytest.mark.parametrize("case", ["dtype", "rank", "shape", "layout",
                                  "device", "meta"])
def test_the_wrapper_refuses(case):
    a, b, _ = inputs(6)
    err = ValueError
    if case == "dtype":
        a, b, err = a.double(), b.double(), TypeError
    elif case == "rank":
        a, b = a[0], b[0]
    elif case == "shape":
        b = b[:, :5]
    elif case == "layout":
        a = a.transpose(0, 2).contiguous().transpose(0, 2)
    elif case == "device":
        b = b.to("meta")
    else:
        a, b = a.to("meta"), b.to("meta")
    with pytest.raises(err):
        linear_scan(a, b)


def test_the_cuda_wrappers_refuse_cpu_tensors():
    a, b, g = inputs(4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        linear_scan_cuda(a, b)
    with pytest.raises(ValueError, match="CUDA tensors"):
        linear_scan_backward_cuda(a, b, g)


# -- the launch plan ---------------------------------------------------------

# the LM's shapes (decode, phase train's, a 32k prefill, a train_4k batch),
# the tails (T around a stage and the threshold, D not a multiple of 32 or
# of 4), few and many tiles
PLAN_SHAPES = [(4, 1, 2560), (8, 128, 1536), (8, 128, 2560),
               (2, 32768, 2560), (16, 4096, 768), (1, 1, 1), (3, 31, 36),
               (3, 33, 1535), (2, SHORT_T - 1, 68), (2, SHORT_T, 68),
               (2, SHORT_T_BACKWARD - 1, 68), (2, SHORT_T_BACKWARD, 68),
               (1, 300, 5), (1, 300, 4), (64, 64, 4096), (1, 32768, 2560)]
H100_OPTIN = 232448          # shared memory a block may opt in to


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_plan_walks_every_channel_once(shape, backward):
    bsz, t_len, d = shape
    plan = scan_plan(shape, backward=backward)
    short_t = SHORT_T_BACKWARD if backward else SHORT_T
    assert plan.staged == (t_len >= short_t and d % 4 == 0)
    assert not scan_plan(shape, backward=backward, aligned=False).staged
    ch = plan_channels(plan, bsz, d)
    assert ch.shape == (plan.grid, plan.threads)
    walked = np.sort(ch[ch >= 0])
    np.testing.assert_array_equal(walked, np.arange(bsz * d))


@pytest.mark.parametrize("backward", [False, True])
@pytest.mark.parametrize("shape", PLAN_SHAPES + [(1 << 12, 8, 1 << 20),
                                                 (1 << 12, 64, 1 << 20)])
def test_plan_fits_the_launch_limits(shape, backward):
    """Grid within 2**31 - 1 blocks, threads within a block's 1,024, and
    shared memory (the ring and the static barriers) within the H100's
    opt-in limit a block (and, staged, the ring's stages of one box an
    operand, a stage a whole number of register chunks)."""
    plan = scan_plan(shape, backward=backward)
    assert 1 <= plan.grid <= 2 ** 31 - 1
    assert 1 <= plan.threads <= 1024
    assert 0 <= plan.smem and plan.smem + BARRIERS <= H100_OPTIN
    if plan.staged:
        box = (3 if backward else 2) * plan.tc * plan.tile * 4
        assert plan.smem == plan.stages * box + RING_PAD
        assert plan.tc % CHUNK == 0 and plan.tc <= 256
        assert 1 <= plan.stages <= -(-shape[1] // plan.tc)
    else:
        assert plan.smem == plan.stages == plan.tc == 0


def test_recorded_launches_hold_the_plan_bytes_to_the_budget():
    """``check.record`` on fake ``cuda`` tensors (as the contract gate runs
    on the CPU) hears both ops' launches with their plans' bytes, which
    ``KernelBudget`` holds against the H100's opt-in limit."""
    from repro_torch.check.recorder import record
    from repro_torch.check.rules import KernelBudget, run_rules
    shape = (2, 4096, 2560)
    a, b, g = (torch.empty(shape) for _ in range(3))
    ops_ = torch.ops.repro_torch
    surf = record(lambda a, b, g: ops_.linear_scan_backward(
        a, ops_.linear_scan(a, b), g), a, b, g, device="cpu")
    assert [(lc.kernel, lc.smem) for lc in surf.launches] == [
        ("linear_scan", scan_plan(shape).smem),
        ("linear_scan_backward", scan_plan(shape, backward=True).smem)]
    rules = (KernelBudget(H100_OPTIN - BARRIERS, require_kernel="linear_scan"),
             KernelBudget(require_kernel="linear_scan_backward",
                          cap_bytes=H100_OPTIN - BARRIERS))
    assert not run_rules(rules, surf)
    assert run_rules((KernelBudget(1024),), surf)


def test_plan_constants_are_the_kernels():
    """The plan's TILE, CHUNK, MAX_STAGES, RING_PAD and WALK_THREADS are
    the constants ``csrc/linear_scan.cu`` is compiled with (the C side
    refuses a plan that disagrees, but only on the card)."""
    import re
    from repro_torch.kernels import _build
    from repro_torch.kernels import linear_scan as L
    src = (_build.CSRC / "linear_scan.cu").read_text()
    consts = dict(re.findall(r"constexpr int (k\w+) = (\d+);", src))
    assert {k: int(v) for k, v in consts.items() if k in (
        "kTile", "kChunk", "kMaxStages", "kRingPad", "kWalkThreads")} == dict(
        kTile=L.TILE, kChunk=L.CHUNK, kMaxStages=L.MAX_STAGES,
        kRingPad=L.RING_PAD, kWalkThreads=L.WALK_THREADS)
