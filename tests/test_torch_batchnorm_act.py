"""Batch norm with a residual add and a ReLU folded in
(sm3x_torch.models.layers.batch_norm_act; kernel K6,
sm3x_torch/ops/batchnorm_cuda.py and csrc/batchnorm.cu).

On the CPU: the plain twin against the composition it replaced
(`F.batch_norm`, then + residual, then ReLU), forward and backward; Flax's
biased running variance and momentum, `recomputing()` and
`num_batches_tracked`; which inputs the dispatch sends to K6 and which keep
`F.batch_norm`; the `model.bn_kernel` / `model.bn_library` counters; the
ResNets' state dict; K6's tile plan at ResNet-50's shapes.

Marked `cuda` and skipped without a card: K6 against float64 arithmetic on
the same inputs (and the twin beside it) at every distinct (N H W, C) of
ResNet-50 at batch 96 and 224 and at ragged shapes, bf16 and float32,
forward and backward; the step count and running statistics; a CUDA
graph's replays against eager steps. This file imports no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_batchnorm_act.py

Tolerances on the card, against float64 on the same inputs: y and dx in
bf16 within 2^-8 of max |reference| (each is rounded once from float32),
in float32 within 1e-5 of it (dx: of the larger of max |dx| and max |gamma
invstd dy'|, the size of the terms it is the difference of; with two rows
a channel dx is nearly 0); the statistics, the running statistics,
dgamma and dbeta (float32 sums of up to 1.2 M terms) within 1e-4
relative.
"""

import pytest
import torch
import torch.nn.functional as F
import torch_ref

from sm3x_torch.models import layers
from sm3x_torch.models.layers import BatchNorm, batch_norm_act, recomputing
from sm3x_torch.models.resnet import build_resnet
from sm3x_torch.ops import batchnorm_cuda as K
from sm3x_torch.utils import profiling
from sm3x_torch.utils.timing import traced_launches

M, EPS = K.MOMENTUM, K.EPS

# (N H W, C) of each batch norm of ResNet-50 at batch 96 and 224
# (N = 96: a view's batch in the SSL step), and how often it occurs in one
# forward pass (53 in all)
R50_SHAPES = {
    (96 * 112 * 112, 64): 1,
    (96 * 56 * 56, 64): 6, (96 * 56 * 56, 256): 4,
    (96 * 56 * 56, 128): 1, (96 * 28 * 28, 128): 7,
    (96 * 28 * 28, 512): 5,
    (96 * 28 * 28, 256): 1, (96 * 14 * 14, 256): 11,
    (96 * 14 * 14, 1024): 7,
    (96 * 14 * 14, 512): 1, (96 * 7 * 7, 512): 5, (96 * 7 * 7, 2048): 4,
}


def _composition(x, weight, bias, rm, rv, steps, residual, relu):
    """The code K6 replaced: torch's train-mode batch norm, the running
    variance corrected to the biased one, + residual, ReLU in place."""
    n = x.numel() // x.shape[1]
    before = rv.clone()
    y = F.batch_norm(x, rm, rv, weight, bias, True, M, EPS)
    rv.data.mul_((n - 1) / n).add_(before, alpha=(1.0 - M) / n)
    steps.add_(1)
    if residual is not None:
        y = y + residual
    return torch.relu_(y) if relu else y


def _leaves(c, gen, dtype=torch.float32, shape=(4, 6, 5)):
    x = torch.randn(shape[0], c, *shape[1:], generator=gen, dtype=dtype)
    res = torch.randn(x.shape, generator=gen, dtype=dtype)
    w = torch.rand(c, generator=gen) + 0.5
    b = torch.randn(c, generator=gen) * 0.1
    state = (torch.randn(c, generator=gen) * 0.1,
             torch.rand(c, generator=gen) + 0.5, torch.tensor(3))
    return x, res, w, b, state


@pytest.mark.parametrize("with_residual", [False, True])
@pytest.mark.parametrize("relu", [False, True])
def test_plain_twin_is_the_composition_it_replaced(with_residual, relu):
    gen = torch.Generator().manual_seed(1)
    x, res, w, b, state = _leaves(16, gen)
    residual = res if with_residual else None
    dy = torch.randn(x.shape, generator=gen)
    out = {}
    for name, fn in (("twin", K.batch_norm_act_plain),
                     ("composition", _composition)):
        leaves = [t.clone().requires_grad_() for t in (x, w, b, res)]
        moving = [t.clone() for t in state]
        y = fn(leaves[0], leaves[1], leaves[2], *moving,
               leaves[3] if with_residual else None, relu)
        y.backward(dy)
        out[name] = [y.detach()] + [t.grad for t in leaves] + moving
    for got, want in zip(out["twin"], out["composition"]):
        if want is None:
            assert got is None
        else:
            assert torch.equal(got, want)
    if residual is None:
        assert out["twin"][4] is None


def test_the_cpu_wrapper_is_the_twin():
    gen = torch.Generator().manual_seed(2)
    x, res, w, b, state = _leaves(8, gen)
    a, c = [t.clone() for t in state], [t.clone() for t in state]
    got = K.batch_norm_act(x, w, b, *a, res, True)
    want = K.batch_norm_act_plain(x, w, b, *c, res, True)
    assert torch.equal(got, want)
    assert all(torch.equal(p, q) for p, q in zip(a, c))


def test_running_statistics_follow_flax():
    """running_mean and running_var move toward the batch mean and the
    *biased* variance with momentum 0.1 (Flax's 0.9), the step count by 1."""
    gen = torch.Generator().manual_seed(3)
    x, res, w, b, (rm, rv, steps) = _leaves(8, gen, torch.float64)
    rm, rv = rm.double(), rv.double()
    want_m = 0.9 * rm + 0.1 * x.mean((0, 2, 3))
    want_v = 0.9 * rv + 0.1 * x.var((0, 2, 3), unbiased=False)
    y = K.batch_norm_act_plain(x, w.double(), b.double(), rm, rv, steps,
                               res, True)
    torch.testing.assert_close(rm, want_m, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(rv, want_v, rtol=1e-12, atol=1e-12)
    assert int(steps) == 4
    xhat = (x - x.mean((0, 2, 3), keepdim=True)) / torch.sqrt(
        x.var((0, 2, 3), unbiased=False, keepdim=True) + EPS)
    want_y = torch.relu(xhat * w.double().view(1, -1, 1, 1)
                        + b.double().view(1, -1, 1, 1) + res)
    torch.testing.assert_close(y, want_y, rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("relu", [False, True])
def test_recomputing_leaves_the_running_statistics_alone(relu):
    gen = torch.Generator().manual_seed(4)
    bn = BatchNorm(8)
    x = torch.randn(3, 8, 4, 4, generator=gen)
    res = torch.randn(x.shape, generator=gen)
    with torch.no_grad():
        bn.running_mean.normal_(generator=gen)
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    with recomputing():
        again = batch_norm_act(bn, x, res, relu)
    for k, v in bn.state_dict().items():
        assert torch.equal(v, before[k]), k
    y = batch_norm_act(bn, x, res, relu)
    assert torch.equal(y, again)
    assert int(bn.num_batches_tracked) == 1
    assert not torch.equal(bn.running_mean, before["running_mean"])


def test_batchnorm_forward_is_batch_norm_act_without_its_tail():
    gen = torch.Generator().manual_seed(5)
    a, b = BatchNorm(16), BatchNorm(16)
    x = torch.randn(4, 16, 3, 3, generator=gen)
    assert torch.equal(a(x), batch_norm_act(b, x, relu=False))
    assert all(torch.equal(p, q) for p, q in zip(a.state_dict().values(),
                                                 b.state_dict().values()))
    a.eval()
    b.eval()
    res = torch.randn(x.shape, generator=gen)
    assert torch.equal(torch.relu(a(x) + res), batch_norm_act(b, x, res))


class _CudaLike:
    """A CPU tensor that reports a CUDA device: the dispatch's view of an
    input, for the rule's tests on a machine without a card."""

    is_cuda = True
    device = torch.device("cuda", 0)

    def __init__(self, t):
        self.t = t
        self.shape, self.dtype = t.shape, t.dtype

    def dim(self):
        return self.t.dim()

    def numel(self):
        return self.t.numel()

    def element_size(self):
        return self.t.element_size()

    def data_ptr(self):
        return 0   # the allocator's tensors are 512-byte aligned

    def is_contiguous(self, **kw):
        return self.t.is_contiguous(**kw)


def _cl(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype).to(memory_format=torch.channels_last)


@pytest.mark.parametrize("x, residual, takes", [
    (_cl((2, 64, 5, 5)), None, True),
    (_cl((2, 2048, 7, 7)), _cl((2, 2048, 7, 7)), True),
    (_cl((2, 16, 3, 3), torch.float32), None, True),
    (torch.zeros(2, 64, 5, 5, dtype=torch.bfloat16), None, False),  # NCHW
    (_cl((2, 64, 5, 5), torch.float16), None, False),
    (_cl((2, 64, 5, 5), torch.float64), None, False),
    (_cl((2, 12, 5, 5)), None, False),                 # C % 8 != 0
    (torch.zeros(8, 64, dtype=torch.bfloat16), None, False),   # 2-D
    (_cl((2, 64, 5, 5)), torch.zeros(2, 64, 5, 5, dtype=torch.bfloat16),
     False),                                           # an NCHW residual
    (_cl((2, 64, 5, 5)), _cl((2, 64, 5, 5), torch.float32), False),
], ids=["c64", "c2048-residual", "float32", "nchw", "float16", "float64",
        "c12", "2d", "nchw-residual", "residual-dtype"])
def test_which_inputs_take_the_kernel(x, residual, takes):
    per_channel = [_CudaLike(torch.zeros(x.shape[1]))] * 4
    res = None if residual is None else _CudaLike(residual)
    assert K.kernel_takes(_CudaLike(x), res, *per_channel) is takes
    assert not K.kernel_takes(x, residual)   # a CPU tensor never does


def test_the_kernel_wants_float32_per_channel_tensors():
    x = _CudaLike(_cl((2, 64, 5, 5)))
    assert not K.kernel_takes(x, None, _CudaLike(
        torch.zeros(64, dtype=torch.bfloat16)))
    assert not K.kernel_takes(x, None, _CudaLike(torch.zeros(32)))


@pytest.fixture
def dispatch(monkeypatch):
    """layers.batch_norm_act with K6's wrapper, its twin, the eval batch norm
    and the global one replaced by recorders; counters on."""
    calls = []

    def recorder(name):
        def fn(*a, **kw):
            calls.append(name)
            return torch.zeros(1)
        return fn

    monkeypatch.setattr(K, "batch_norm_act", recorder("kernel"))
    monkeypatch.setattr(K, "batch_norm_act_plain", recorder("plain"))
    monkeypatch.setattr(layers.F, "batch_norm", recorder("eval"))
    monkeypatch.setattr(BatchNorm, "_global_batch_forward",
                        lambda self, x: recorder("global")(x))
    profiling.take()
    profiling.record(True)
    try:
        yield calls
    finally:
        profiling.record(False)
        profiling.take()


def _counters():
    return {k: v for k, v in profiling.take().counters.items()
            if k.startswith("model.bn_")}


@pytest.mark.parametrize("x, mode, route", [
    (_cl((4, 64, 5, 5)), "train", "kernel"),
    (_cl((4, 64, 5, 5), torch.float32), "train", "kernel"),
    (_cl((4, 64, 5, 5)), "eval", "eval"),
    (_cl((4, 64, 5, 5)), "distributed", "global"),
    (torch.zeros(4, 64, 5, 5, dtype=torch.bfloat16), "train", "plain"),
    (_cl((4, 64, 5, 5), torch.float16), "train", "plain"),
    (_cl((4, 20, 5, 5)), "train", "plain"),                   # C % 8 != 0
    (torch.zeros(96, 64), "train", "plain"),                  # projector
], ids=["bf16", "float32", "eval", "distributed", "nchw", "float16", "c20",
        "2d"])
def test_the_dispatch_rule_and_its_counters(dispatch, monkeypatch, x, mode,
                                            route):
    bn = BatchNorm(x.shape[1])
    bn.train(mode != "eval")
    for name in ("weight", "bias", "running_mean", "running_var"):
        # found before the module's own lookup of its tensors
        object.__setattr__(bn, name, _CudaLike(getattr(bn, name)))
    monkeypatch.setattr(layers, "is_distributed",
                        lambda: mode == "distributed")
    batch_norm_act(bn, _CudaLike(x), relu=False)
    assert dispatch == [route]
    kernel = route == "kernel"
    assert _counters() == {f"model.bn_{'kernel' if kernel else 'library'}": 1}


def test_the_cpu_counts_library_calls_in_a_resnet():
    model = build_resnet("resnet18")
    profiling.take()
    profiling.record(True)
    try:
        model(torch.randn(2, 32, 32, 3))
    finally:
        profiling.record(False)
    # stem 1, eight blocks of 2, three downsample branches
    assert _counters() == {"model.bn_library": 20}


def test_one_value_a_channel_is_refused():
    with pytest.raises(ValueError, match="more than one value"):
        batch_norm_act(BatchNorm(8), torch.zeros(1, 8, 1, 1))


@pytest.mark.parametrize("arch, oracle", [
    ("resnet18", torch_ref.torch_resnet18),
    ("resnet50", torch_ref.torch_resnet50)])
def test_resnet_state_dict_keeps_its_keys(arch, oracle):
    with torch.device("meta"):   # shapes without memory
        got = {k: tuple(v.shape) for k, v in
               build_resnet(arch).state_dict().items()}
        want = {k: tuple(v.shape) for k, v in oracle().state_dict().items()}
    assert got == want


def _resnet18_pair(gen):
    x = torch.randn(2, 32, 32, 3, generator=gen)
    return (build_resnet("resnet18"), torch_ref.torch_resnet18(), x,
            lambda t: t.permute(0, 3, 1, 2))


def _bottleneck_pair(gen):
    """One stride-2 Bottleneck with its downsample branch: bn1, bn2, and
    bn3 with the residual, each with its ReLU."""
    from sm3x_torch.models.resnet import Bottleneck

    down = torch.nn.Sequential(torch.nn.Conv2d(64, 64, 1, 2, bias=False),
                               torch.nn.BatchNorm2d(64))
    x = torch.randn(2, 64, 8, 8, generator=gen)
    return (Bottleneck(64, 16, 2, downsample=True),
            torch_ref.Bottleneck(64, 16, 2, down), x, lambda t: t)


@pytest.mark.parametrize("pair", [_resnet18_pair, _bottleneck_pair],
                         ids=["resnet18", "bottleneck"])
def test_train_step_is_the_torch_oracle(pair):
    """In float32 on the CPU the port's blocks (the twin in every batch
    norm) compute what torchvision's layout with nn.BatchNorm2d computes:
    the output, the input's gradient and the running means; the running
    variance is Flax's (biased) where torch's is unbiased."""
    gen = torch.Generator().manual_seed(6)
    model, oracle, x, layout = pair(gen)
    torch_ref.randomize_bn_stats(oracle, gen)
    model.load_state_dict(oracle.state_dict(), strict=True)
    x.requires_grad_()
    xo = layout(x.detach()).clone().requires_grad_()
    f = model(x)
    fo = oracle(xo)
    torch.testing.assert_close(f, fo, rtol=1e-5, atol=1e-6)
    f.square().sum().backward()
    fo.square().sum().backward()
    torch.testing.assert_close(layout(x.grad), xo.grad, rtol=1e-4, atol=1e-6)
    want = oracle.state_dict()
    for k, v in model.state_dict().items():
        if k.endswith(("running_mean", "num_batches_tracked")):
            torch.testing.assert_close(v, want[k], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("rows, c", sorted(R50_SHAPES) + [
    (1, 8), (7, 8), (33, 24), (1000, 136), (5, 4096)])
def test_the_plan_covers_every_row_and_channel(rows, c, itemsize):
    chunks, tc_log2, columns, blocks = K.plan(rows, c, itemsize)
    tc = 1 << tc_log2
    assert chunks * 16 == c * itemsize
    assert tc <= min(1 << K.MAX_TC_LOG2, chunks)
    assert columns * tc >= chunks > (columns - 1) * tc
    tiles = -(-rows // ((K.THREADS // tc) * K.UNROLL))
    assert 1 <= blocks <= tiles
    # the reductions fill the card where the rows allow it
    assert blocks * columns >= min(tiles * columns,
                                   K.REDUCE_BLOCKS_PER_SM * K.SMS)


def test_the_r50_shapes_count_its_batch_norms():
    assert sum(R50_SHAPES.values()) == 53
    with torch.device("meta"):
        model = build_resnet("resnet50")
    assert sum(isinstance(m, BatchNorm) for m in model.modules()) == 53


# --- on the card --------------------------------------------------------

@pytest.fixture(scope="module")
def card():
    """The CUDA device, with the kernels built; skips without a card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sm3x_torch.ops import _native

    _native.library()
    return torch.device("cuda")


def _on_card(rows, c, dtype, card, seed, n=None):
    """(x, residual, dy, weight, bias) on the card: x with a per-channel
    offset and scale (the statistics' hard case), rows as (n, rows / n, 1)
    images."""
    n = n or (96 if rows % 96 == 0 else 1)
    gen = torch.Generator(device=card).manual_seed(seed)
    shape = (n, rows // n, 1, c)

    def draw(scale=1.0, shift=0.0):
        t = torch.randn(shape, generator=gen, device=card) * scale + shift
        return t.to(dtype).permute(0, 3, 1, 2)

    x = draw(torch.rand(c, generator=gen, device=card) * 3 + 0.1,
             torch.randn(c, generator=gen, device=card) * 4)
    w = torch.rand(c, generator=gen, device=card) + 0.5
    b = torch.randn(c, generator=gen, device=card) * 0.3
    return x, draw(), draw(), w, b


def _reference(x, res, dy, w, b, rm, rv, mask_from):
    """float64: y, the running statistics after one step, dx, d_res, dw, db;
    the ReLU's mask from `mask_from` (K6's y), so that a value within
    rounding of 0 cannot flip it."""
    x64, w64, b64 = x.double(), w.double(), b.double()
    dims = (0, 2, 3)
    mean = x64.mean(dims)
    var = x64.var(dims, unbiased=False)
    invstd = 1 / torch.sqrt(var + EPS)
    xhat = (x64 - mean.view(1, -1, 1, 1)) * invstd.view(1, -1, 1, 1)
    v = xhat * w64.view(1, -1, 1, 1) + b64.view(1, -1, 1, 1)
    if res is not None:
        v = v + res.double()
    y = v if mask_from is None else torch.relu(v)
    g = dy.double()
    if mask_from is not None:
        g = g * (mask_from > 0)
    n = x.numel() // x.shape[1]
    s1, s2 = g.sum(dims), (g * xhat).sum(dims)
    dx = (w64 * invstd).view(1, -1, 1, 1) * (
        g - (s1 / n).view(1, -1, 1, 1) - xhat * (s2 / n).view(1, -1, 1, 1))
    # dx is a difference of terms of this size (near 0 where a channel's
    # rows are few): its rounding is relative to them
    dx_scale = ((w64 * invstd).view(1, -1, 1, 1) * g).abs().max().item()
    return dict(y=y, rm=0.9 * rm.double() + 0.1 * mean,
                rv=0.9 * rv.double() + 0.1 * var, dx=dx, dres=g, dw=s2,
                db=s1, mean=mean, invstd=invstd, dx_scale=dx_scale)


def _near(got, want, tol, what, scale=None):
    scale = max(want.abs().max().item(), scale or 0.0, 1e-30)
    err = (got.double() - want).abs().max().item()
    assert err <= tol * scale, (what, err, scale)
    return err / scale


def _k6_step(x, res, dy, w, b, relu, card):
    """One K6 forward and backward on fresh running statistics: outputs,
    gradients, statistics."""
    c = x.shape[1]
    rm = torch.zeros(c, device=card)
    rv = torch.ones(c, device=card)
    steps = torch.zeros((), dtype=torch.long, device=card)
    leaves = [t.clone().requires_grad_() for t in (x, w, b)]
    r = None if res is None else res.clone().requires_grad_()
    y = K.batch_norm_act(*leaves, rm, rv, steps, r, relu)
    y.backward(dy)
    return dict(y=y.detach(), rm=rm, rv=rv, steps=steps, dx=leaves[0].grad,
                dw=leaves[1].grad, db=leaves[2].grad,
                dres=None if r is None else r.grad)


RAGGED = [(2, 8), (3, 8), (33, 24), (1000, 136), (4099, 64), (96 * 9, 2056)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("rows, c", sorted(R50_SHAPES) + RAGGED)
def test_k6_matches_float64_and_its_twin(card, rows, c, dtype):
    x, res, dy, w, b = _on_card(rows, c, dtype, card, seed=rows + c)
    tol = 2.0 ** -8 if dtype == torch.bfloat16 else 1e-5
    for relu, residual in ((True, None), (True, res), (False, None)):
        got = _k6_step(x, residual, dy, w, b, relu, card)
        want = _reference(x, residual, dy, w, b, torch.zeros(c, device=card),
                          torch.ones(c, device=card),
                          got["y"] if relu else None)
        what = f"{rows}x{c} {dtype} relu {relu} residual {residual is not None}"
        _near(got["y"], want["y"], tol, what + " y")
        _near(got["dx"], want["dx"], tol, what + " dx", want["dx_scale"])
        for k in ("rm", "rv", "dw", "db"):
            _near(got[k], want[k], 1e-4, f"{what} {k}")
        assert int(got["steps"]) == 1
        if residual is None:
            assert got["dres"] is None
        elif relu:
            _near(got["dres"], want["dres"], tol, what + " dres")
        # the twin (torch's kernels, three roundings) against the same
        # reference, for scale
        twin = K.batch_norm_act_plain(
            x, w, b, torch.zeros(c, device=card), torch.ones(c, device=card),
            torch.zeros((), dtype=torch.long, device=card), residual, relu)
        _near(twin, want["y"], 3 * tol, what + " twin y")


@pytest.mark.cuda
def test_k6_repeats_its_bits_and_counts_launches(card):
    x, res, dy, w, b = _on_card(96 * 28 * 28, 512, torch.bfloat16, card, 7)
    steps = []
    launched = traced_launches(lambda _: steps.append(
        _k6_step(x, res, dy, w, b, True, card)), 2)
    a, again = steps[-2:]
    for k, v in a.items():
        assert torch.equal(v, again[k]), k
    assert (launched["bn_forward_cuda"],
            launched["bn_backward_cuda"]) == (4, 4)


@pytest.mark.cuda
def test_k6_under_recomputing_and_a_frozen_weight(card):
    x, res, dy, w, b = _on_card(96 * 14 * 14, 256, torch.bfloat16, card, 8)
    bn = BatchNorm(256).to(card)
    bn.weight.requires_grad_(False)
    before = {k: v.clone() for k, v in bn.state_dict().items()}
    xs = x.clone().requires_grad_()
    with recomputing():
        y = batch_norm_act(bn, xs, res)
    y.backward(dy)
    for k, v in bn.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert bn.weight.grad is None and bn.bias.grad is not None
    want = _k6_step(x, res, dy, bn.weight.detach(), bn.bias.detach(), True,
                    card)
    assert torch.equal(y.detach(), want["y"])
    assert torch.equal(xs.grad, want["dx"])


@pytest.mark.cuda
def test_k6_refuses_what_it_does_not_take(card):
    x = torch.zeros(2, 12, 3, 3, device=card).to(
        memory_format=torch.channels_last)
    with pytest.raises(ValueError, match="bn_forward_cuda takes"):
        K.bn_forward_cuda(x, None, None, None, None, None)
    x = torch.zeros(2, 16, 3, 3, device=card)
    with pytest.raises(ValueError, match="bn_forward_cuda takes"):
        K.bn_forward_cuda(x, None, None, None, None, None)


@pytest.mark.cuda
def test_resnet_on_the_card_counts_kernel_calls(card):
    model = build_resnet("resnet18").to(card)
    x = torch.randn(4, 64, 64, 3, device=card)
    profiling.take()
    profiling.record(True)
    try:
        with torch.autocast("cuda", dtype=torch.bfloat16):
            model(x).sum().backward()
    finally:
        profiling.record(False)
    assert _counters() == {"model.bn_kernel": 20}


@pytest.mark.cuda
def test_graph_replays_move_the_statistics_as_eager_steps(card):
    """Two replays of a captured forward and backward give the running
    statistics and step count of two eager steps, bit for bit: the
    kernels' arrival counters reset themselves."""
    x, res, dy, w, b = _on_card(96 * 7 * 7, 2048, torch.bfloat16, card, 9)
    bns = [BatchNorm(2048).to(card) for _ in range(2)]
    xs = x.clone().requires_grad_()

    def step(bn):
        y = batch_norm_act(bn, xs, res)
        y.backward(dy)
        return y

    for _ in range(3):
        step(bns[0])
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        step(bns[1])   # the warm-up a capture wants
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step(bns[1])
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    for k, v in bns[0].state_dict().items():
        assert torch.equal(v, bns[1].state_dict()[k]), k
    assert int(bns[1].num_batches_tracked) == 3
