"""V-MoE in the port (`sm3x_torch.models.vmoe`, `sm3x_torch.ops.moe`,
kernel K5) against the benchmark's plain reference
(`portbench/reference/vmoe.py`, `portbench/stages/ssl_moe.py`), at a toy
size on the CPU: D 32, 4 heads, 4 blocks of which 2 are MoE (1 and 3), 4
experts, k 2, capacity ratio 1.05, 32-pixel images, patch 8.

float32 on both sides; the tolerances are float32 round-off: the program's
experts are one batched product over (E, C, D) where the reference loops
over the experts, and the two sum in other orders (read at 2e-6 and less),
while the same run with the reference's products in fp8 (the benchmark's
control) reads above 0.1 on every number. The inputs are drawn from seeded
generators, so that a run reads what the last one read.

Marked `cuda` and skipped without a card: K5 against its plain twin at the
cell's shapes (bf16 and float32), the graphed V-MoE step against the eager
one, and no host synchronisation inside the step. On a machine without
JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_vmoe.py
"""

import dataclasses
import json
import shutil
from pathlib import Path

import pytest
import torch

from portbench.harness import checks, spec
from portbench.harness.inputs import load_weights, paired_split
from portbench.reference import vmoe as ref_vmoe
from sm3x_torch.core import prng
from sm3x_torch.core.config import SSLConfig
from sm3x_torch.models import vmoe
from sm3x_torch.ops import moe
from sm3x_torch.train import backbone_train as bt
from sm3x_torch.train import common


REPO = Path(__file__).resolve().parents[1]
TOY = dict(patch=8, dim=32, depth=4, n_heads=4, experts=4, k=2,
           moe_blocks=(1, 3), capacity_ratio=1.05)
# on the card: K3 takes heads of 64
TOY_CARD = dict(TOY, dim=128, n_heads=2)
# float32 round-off between a batched and a looped expert product (read
# 6.8e-7 / 1.4e-6 / 2.3e-6 / 1.1e-5; the fp8 control 0.18 / 0.33 / 0.97 /
# 0.27); change_gap is Adam's step over gradients near zero, 10x wider
LIMITS = {"loss_gap": 1e-5, "proj_gap": 2e-5, "grad_gap": 5e-5,
          "change_gap": 3e-4}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this file: at two, on a loaded host, the
    port's float32 CPU attention (torch's einsum and logsumexp) gave other
    bits from the same q, k and v about one run in twenty, which the
    comparisons below read as a gap of 3e-5."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module", autouse=True)
def toy_arch():
    vmoe.VMOE_SPECS.update(vmoe_toy=TOY, vmoe_card=TOY_CARD)
    yield
    del vmoe.VMOE_SPECS["vmoe_toy"], vmoe.VMOE_SPECS["vmoe_card"]


@pytest.fixture(scope="module")
def toy_cell(tmp_path_factory):
    """The cell `vmoe_b16_ssl_recipe` cut to the toy: its configuration
    and traffic files with the toy's widths, 24 cases of 48-pixel canvases,
    batch 8."""
    root = tmp_path_factory.mktemp("cell")
    bench = REPO / "portbench"
    for d in ("workloads", "configs", "traffic"):
        (root / d).mkdir()
    c = json.loads((bench / "configs/sm3_vmoe_b16.json").read_text())
    c.update(arch="vmoe_toy", patch=8, hidden=32, depth=4, heads=4,
             feat_dim=32, img_size=32, proj_dim=16)
    # the seeded routers: the toy routes by its logits, not by noise alone
    c["moe"].update(experts=4, blocks=[1, 3], router_init="seeded")
    (root / "configs/toy_moe.json").write_text(json.dumps(c))
    shutil.copy(bench / "configs/sm3_vmoe_b16.py", root / "configs/toy_moe.py")
    t = json.loads((bench / "traffic/ssl_recipe_moe.json").read_text())
    t.update(cases=24, canvas=48)
    (root / "traffic/toy_mix.json").write_text(json.dumps(t))
    (root / "workloads/toy.json").write_text(json.dumps(
        {"config": "toy_moe", "traffic": "toy_mix", "chips": 1, "batch": 8,
         "why": "toy", "limits": LIMITS}))
    return spec.load_cell("toy", root)


def _pair(seed=3):
    """The port's toy encoder and the reference's, on one seeded set of
    weights."""
    port = vmoe.build_vmoe("vmoe_toy", img_size=32, remat="flash")
    ref = ref_vmoe.VMoE(8, 32, 4, 4, 4.0, 32, 1e-6, 4, 2, (1, 3), 1.05)
    shapes = {n: p.shape for n, p in ref.named_parameters()}
    assert {n: p.shape for n, p in port.named_parameters()} == shapes
    load_weights(port, seed, "cpu")
    load_weights(ref, seed, "cpu")
    return port, ref


def test_an_encoder_call_matches_the_reference():
    """Features, the blocks' mean aux loss, the dropped choices and the
    input's gradient of one training call, on the same weights and noise
    (the program draws it from the encoder's generator by the rule the
    reference's `noises` restates)."""
    port, ref = _pair()
    x = torch.rand(6, 32, 32, 3, generator=torch.Generator().manual_seed(0),
                   requires_grad=True)
    seed = 11
    with vmoe.routing(port, [torch.Generator().manual_seed(seed)]) as log:
        f = port(x)
    noises = ref_vmoe.noises(torch.Generator().manual_seed(seed), 1,
                             6 * 17, 4, 2, "cpu")[0]
    xr = x.detach().clone().requires_grad_()
    fr, aux, dropped = ref(xr, noises)
    assert len(log.calls) == 1
    torch.testing.assert_close(f, fr, rtol=0, atol=2e-6)
    torch.testing.assert_close(log.calls[0][0], aux, rtol=1e-5, atol=0)
    assert float(log.calls[0][1]) == dropped > 0
    assert log.calls[0][2] == 2 * 6 * 17 * 2
    (f.square().sum() + log.calls[0][0]).backward()
    (fr.square().sum() + aux).backward()
    torch.testing.assert_close(x.grad, xr.grad, rtol=0, atol=2e-6)


def test_the_eval_path_draws_no_noise_and_logs_no_aux():
    """In eval the router is noise-free whatever the generator, and no call
    is logged: the forward is the reference's with no noise."""
    port, ref = _pair()
    port.eval()
    x = torch.rand(4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    outs = []
    for g in (1, 2):
        with vmoe.routing(port, [torch.Generator().manual_seed(g)]) as log:
            outs.append(port(x))
        assert log.calls == []
    assert torch.equal(outs[0], outs[1])
    fr, aux, _ = ref(x, None)
    assert aux is None
    torch.testing.assert_close(outs[0], fr, rtol=0, atol=2e-6)


def test_the_capacity_cut_keeps_first_choices_first_in_token_order():
    """A hand-built routing in which both experts overflow: 5 tokens, 2
    experts of capacity 3. Expert 0 takes the first choices of tokens 0, 1
    and 3; token 4's first choice and token 2's second come after them and
    are dropped. Expert 1 takes token 2's first choice, then the second
    choices of tokens 0 and 1; those of tokens 3 and 4 are dropped."""
    choices = torch.tensor([[0, 1], [0, 1], [1, 0], [0, 1], [0, 1]])
    smap = moe.slot_map(choices, experts=2, cap=3)
    # slots: expert 0 at 0..2, expert 1 at 3..5; choice a = t * 2 + j
    assert smap.slot_assign.tolist() == [0, 2, 6, 4, 1, 3]
    assert smap.token_slot.tolist() == [[0, 4], [1, 5], [3, -1],
                                         [2, -1], [-1, -1]]
    assert float(smap.dropped) == 4
    assert moe.capacity(5, 2, 2, 1.05) == 5
    assert moe.capacity(64 * 197, 2, 32, 1.05) == 827


def _maps(seed, n=13, experts=4, k=2, cap=5):
    g = torch.Generator().manual_seed(seed)
    choices = torch.stack([torch.randperm(experts, generator=g)[:k]
                           for _ in range(n)])
    return moe.slot_map(choices, experts, cap), n, experts * cap, k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_s_plain_twin_is_the_direct_loop(dtype):
    """Dispatch, combine and both backwards of the plain twin against a
    loop over tokens and slots, in float32 and bf16 rows (float32 sums,
    one rounding)."""
    smap, n, s, k = _maps(1)
    d = 24
    x = torch.randn(n, d).to(dtype)
    y = torch.randn(s, d).to(dtype)
    gates = torch.rand(n, k)
    dout = torch.randn(n, d).to(dtype)
    slots = moe.dispatch_plain(x, smap.slot_assign, k)
    out = moe.combine_plain(y, gates, smap.token_slot)
    dy, dg = moe.combine_backward_plain(dout, y, gates, smap.slot_assign,
                                        smap.token_slot)
    dx = moe.dispatch_backward_plain(y, smap.token_slot)
    want_slots = torch.zeros(s, d, dtype=dtype)
    want_dy = torch.zeros(s, d)
    for slot, a in enumerate(smap.slot_assign.tolist()):
        if a >= 0:
            want_slots[slot] = x[a // k]
            want_dy[slot] = gates.view(-1)[a] * dout[a // k].float()
    want_out = torch.zeros(n, d)
    want_dg = torch.zeros(n, k)
    want_dx = torch.zeros(n, d)
    for t in range(n):
        for j in range(k):
            slot = int(smap.token_slot[t, j])
            if slot >= 0:
                want_out[t] += gates[t, j] * y[slot].float()
                want_dg[t, j] = (dout[t].float() * y[slot].float()).sum()
                want_dx[t] += y[slot].float()
    assert torch.equal(slots, want_slots)
    assert torch.equal(out, want_out.to(dtype))
    assert torch.equal(dy, want_dy.to(dtype))
    torch.testing.assert_close(dg, want_dg, rtol=1e-6, atol=1e-6)
    assert torch.equal(dx, want_dx.to(dtype))


def test_dispatch_and_combine_pass_gradcheck_in_float64():
    smap, n, s, k = _maps(2)
    x = torch.randn(n, 6, dtype=torch.float64, requires_grad=True)
    y = torch.randn(s, 6, dtype=torch.float64, requires_grad=True)
    g = torch.rand(n, k, dtype=torch.float64, requires_grad=True)
    assert torch.autograd.gradcheck(lambda x: moe.dispatch(x, smap), (x,))
    assert torch.autograd.gradcheck(lambda y, g: moe.combine(y, g, smap),
                                    (y, g))


def test_the_blocked_reference_is_one_unblocked_pass(toy_cell):
    stage = spec.load_stage(toy_cell)
    t = toy_cell.traffic
    split = paired_split(t["cases"], t["canvas"], 4)
    a = stage.first_steps(toy_cell, split, 4, "cpu")
    b = stage.first_steps(toy_cell, split, 4, "cpu", blocked=False)
    found = checks.gaps(a, b)
    assert all(v <= 1e-6 for v, _ in found.values()), found


def test_three_trainer_steps_match_the_reference_and_the_control_fails(
        toy_cell):
    """The benchmark's comparison at the toy size: three steps of
    `SSLTrainer` (`--arch vmoe_toy`) against the blocked reference, within
    float32 round-off; the reference in fp8 fails every number of it."""
    stage = spec.load_stage(toy_cell)
    seed = 2 ** 31 + 5
    run = stage.Run(toy_cell, seed, "cpu")
    run.build()
    prog = run.first_epoch()
    split = run.split
    stat = run.trainer.train_epoch(run.feed, 1)
    run.free()
    ref = stage.reference(toy_cell, split, seed, "cpu")
    ok, numbers = checks.judge(checks.gaps(prog, ref), LIMITS)
    assert ok, numbers
    assert 0 < stat["moe_dropped"] < stat["moe_assignments"]
    assert stat["moe_assignments"] == 3 * 4 * 2 * 8 * 17 * 2
    ctl = stage.reference(toy_cell, split, seed, "cpu", numerics="fp8")
    ok, numbers = checks.judge(checks.gaps(ctl, ref), LIMITS)
    assert all(n["value"] > n["limit"] for n in numbers.values()), numbers


def test_routers_started_at_zero_route_by_noise_and_match(toy_cell):
    """`router_init` "zero", the cell's: both sides' routers start at zero,
    the first steps route by the noise alone and still match within
    float32 round-off, and a router's change is read from zero (from the
    seeded draw it would read near 1)."""
    moe_cfg = dict(toy_cell.config["moe"], router_init="zero")
    cell = dataclasses.replace(toy_cell,
                               config=dict(toy_cell.config, moe=moe_cfg))
    stage = spec.load_stage(cell)
    seed = 2 ** 31 + 9
    run = stage.Run(cell, seed, "cpu")
    run.build()
    routers = [n for n, _ in run.routers]
    assert len(routers) == 4 and all(
        float(p.detach().abs().max()) == 0.0 for _, p in run.routers)
    prog = run.first_epoch()
    split = run.split
    run.free()
    ref = stage.reference(cell, split, seed, "cpu")
    ok, numbers = checks.judge(checks.gaps(prog, ref), LIMITS)
    assert ok, numbers
    for n in routers:
        assert 0 < prog.change[n] == pytest.approx(ref.change[n], rel=1e-3)


def test_the_configuration_counts_46_gflop_an_image():
    """V-MoE-B/16 at 224: ViT-B/16's 35.1 GFLOP, one more MLP pass a token
    in each of the 6 MoE blocks and the router: 46.3 GFLOP, the nominal
    count (every choice counted, kept or dropped)."""
    cell = spec.load_cell("vmoe_b16_ssl_recipe")
    got = cell.model.forward_flops(cell.config, 224)
    assert got == pytest.approx(46.34e9, rel=1e-3)
    shapes = spec.load_stage(cell).step_shapes(cell)
    assert shapes["moe"] == dict(groups=4, n=12608, experts=32, k=2, cap=827,
                                 d=768, launches=24)
    assert len(shapes["k3"]) == 48 and len(shapes["k1"]) == 4


def _slice():
    from portbench.harness.trace import Slice

    # one step: dispatch 1 ms .. combine ends at 5 ms; combine backward 10
    # .. dispatch backward ends at 12 ms; another kernel in between
    ks = [("void sm3x::moe_dispatch_fwd_kernel(...)", 0.000, 0.001),
          ("nvjet_gemm", 0.001, 0.004),
          ("void sm3x::moe_combine_fwd_kernel<__nv_bfloat16>(...)", 0.004,
           0.005),
          ("void sm3x::moe_combine_bwd_kernel<__nv_bfloat16>(...)", 0.010,
           0.011),
          ("void sm3x::moe_dispatch_bwd_kernel<__nv_bfloat16>(...)", 0.0115,
           0.012)]
    return Slice(ks, 0.0, 0.02, steps=1)


def test_the_expert_layer_s_readers_and_their_silence_elsewhere():
    """`moe.experts_ms_per_step` spans dispatch to combine and combine
    backward to dispatch backward; `moe.k5_roofline_pct` is the bound, at
    the traced epochs' drop share, over the four kernels' time;
    `moe.dropped_pct` the share of the window's first epochs. Each
    reads nothing in a cell without the expert layer (the parent's program
    or another configuration): no `moe` shapes, no K5 kernel, no counts."""
    from portbench.harness.kernels_moe import k5_bounds_s, k5_bytes
    from portbench.harness.trace import Slice

    # nothing dropped: every token's row and every slot's once
    full = k5_bytes(12608, 2, 32, 827, 768)
    assert full["dispatch_fwd"] == (12608 + 26464) * 768 * 2 + 26464 * 4
    half = k5_bytes(12608, 2, 32, 827, 768, kept=12608)
    assert all(half[kind] < full[kind] for kind in full)

    readers = spec.metric_readers()
    shape = dict(groups=4, n=12608, experts=32, k=2, cap=827, d=768)
    ctx = dict(slice=_slice(), shapes={"moe": shape},
               window={"moe_dropped": 3.0, "moe_assignments": 300.0,
                       "moe_traced_dropped": 2.0,
                       "moe_traced_assignments": 100.0})
    assert readers["moe.experts_ms_per_step"].read(ctx) == pytest.approx(7.0)
    bound = sum(k5_bounds_s(12608, 2, 32, 827, 768,
                            kept=0.98 * 2 * 12608).values())
    assert readers["moe.k5_roofline_pct"].read(ctx) == pytest.approx(
        100 * bound / 0.0035)
    assert readers["moe.dropped_pct"].read(ctx) == pytest.approx(1.0)
    bare = dict(slice=Slice([("nvjet_gemm", 0.0, 0.001)], 0.0, 0.01, 1),
                shapes={"k1": [], "k3": []}, window={"steps": 3})
    for name in ("moe.experts_ms_per_step", "moe.k5_roofline_pct",
                 "moe.dropped_pct"):
        assert readers[name].read(bare) is None


def test_the_window_reads_its_first_epochs_and_the_traced_ones(
        toy_cell, monkeypatch):
    """The window's drop counts are its first `READ_EPOCHS` epochs' (the
    routers learn through the window, so a fixed count keeps the share
    apart from the step's speed); the traced epochs' are kept apart."""
    from portbench.stages import ssl

    stage = spec.load_stage(toy_cell)
    epochs = stage.READ_EPOCHS + 3

    def window(self, seconds, trace=False):
        self.window_calls = 0
        for e in range(epochs):
            self._epoch(e)
        self.tracer = object()
        self._epoch(epochs)
        return {}

    monkeypatch.setattr(ssl.SSLRun, "_epoch", lambda self, e: dict(
        moe_dropped=float(e), moe_assignments=100.0))
    monkeypatch.setattr(ssl.SSLRun, "window", window)
    win = stage.Run(toy_cell, 1, "cpu").window(1.0, trace=True)
    n = stage.READ_EPOCHS
    assert win["moe_dropped"] == n * (n - 1) / 2
    assert win["moe_assignments"] == 100.0 * n
    assert (win["moe_traced_dropped"], win["moe_traced_assignments"]) == (
        float(epochs), 100.0)


def _cfg(tmp_path, device="cpu") -> SSLConfig:
    cfg = SSLConfig()
    cfg.model.proj_dim = 16
    cfg.model.arch = "vmoe_toy" if device == "cpu" else "vmoe_card"
    cfg.model.arch_version, cfg.model.use_checkpoint = "v32", "flash"
    cfg.data.img_sz, cfg.data.cache_size = (32, 32), 48
    cfg.optim.batch_size, cfg.optim.amp = 8, device != "cpu"
    cfg.optim.base_lr = 1e-4
    cfg.run.world_size, cfg.run.device = 2, device
    cfg.run.log_path, cfg.run.print_freq = str(tmp_path), 10 ** 6
    return cfg


def _canvases(device, it):
    g = torch.Generator().manual_seed(it)
    canv = torch.randint(0, 256, (8, 48, 48, 3), generator=g,
                         dtype=torch.uint8).to(device)
    hw = torch.full((8, 2), 48, dtype=torch.int32).to(device)
    return canv, hw


def test_the_recorded_update_draws_the_routers_as_the_eager_step(tmp_path):
    """Six generators a step (four views, two routers seeded with the
    step's seed and 3, 4 folded in): `update` on them, what a graph
    records, is the eager step bitwise, aux and drop counts included."""
    runs = []
    for recorded in (False, True):
        tr = bt.SSLTrainer(_cfg(tmp_path))
        step = tr.train_step
        seeds = step.seeds(123)
        assert len(seeds) == 6
        assert seeds[4:] == (prng.fold_in(123, 3), prng.fold_in(123, 4))
        gens = [torch.Generator() for _ in seeds]
        outs = []
        for it in range(2):
            canv, hw = _canvases("cpu", it)
            seed = prng.step_seed(tr.cfg.run.seed, 0, it)
            if recorded:
                for g, s in zip(gens, step.seeds(seed)):
                    g.manual_seed(s)
                out = step.update(canv, hw, canv.flip(1), hw, gens)
            else:
                out = step(canv, hw, canv.flip(1), hw, seed)
            outs.append({k: float(v) for k, v in out.items()})
        runs.append(outs)
    assert runs[0] == runs[1]
    assert {"moe_aux", "moe_dropped", "moe_assignments"} <= set(runs[0][0])
    assert runs[0][0]["moe_aux"] > 0
    # a model without expert layers keeps the views' four generators
    plain = bt.make_ssl_train_step(torch.nn.Linear(2, 2), None, 0, 0.1, 2,
                                   (0.5,) * 3, (0.5,) * 3)
    assert plain.seeds(123) == bt.view_seeds(123)


def test_where_v_moe_cannot_go_it_is_refused(tmp_path):
    """Tensor parallelism (the trainer's check and the block's own), the
    eval-BN fast step, the tri-modal and multi-crop steps (which draw no
    router noise and add no aux loss), and the Flax weight mapping."""
    from sm3x_torch.utils.weights import vit_state_dict

    for attr, value, words in (("run.mesh_model", 2, "expert parallelism"),
                               ("model.bn_stat_freq", 2, "bn-stat-freq"),
                               ("model.arch_version", "trimodal", "trimodal"),
                               ("data.data_name", bt.MULTICROP, "multi-crop")):
        cfg = _cfg(tmp_path)
        part, name = attr.split(".")
        setattr(getattr(cfg, part), name, value)
        assert any(words in p for p in bt.unsupported(cfg)), attr
    blk = vmoe.build_vmoe("vmoe_toy", img_size=32).block1
    with pytest.raises(ValueError, match="expert parallelism"):
        blk.split_for_model(2, 0, None)
    with pytest.raises(ValueError, match="V-MoE"):
        vit_state_dict({"patch_embed": {}, "block1": {"moe": {}}})
    assert bt.unsupported(_cfg(tmp_path)) == []
    assert bt.graph_refusals(_cfg(tmp_path, "cuda"), "cuda", False) == []


# --- on the card ----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: kernel K5 and the graph run on "
                    "the card only")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from sm3x_torch.ops import _native

    _native.library()
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_k5_matches_its_twin_at_the_cell_s_shapes(card, dtype):
    """One group of the cell (N 12,608, E 32, k 2, C 827, D 768): each of
    K5's four kernels equal to the plain twin, bitwise where the twin sums
    in the kernel's order (dispatch, combine, dy, dx), the gate gradient
    within float32 round-off of a 768-term dot product; twice the same
    bits."""
    n, e, k, d = 64 * 197, 32, 2, 768
    cap = moe.capacity(n, k, e, 1.05)
    g = torch.Generator(device=card).manual_seed(5)
    logits = torch.randn(n, e, device=card, generator=g)
    gates, choices = torch.softmax(logits, -1).topk(k, dim=-1)
    smap = moe.slot_map(choices, e, cap)
    x = torch.randn(n, d, device=card, generator=g).to(dtype)
    y = torch.randn(e * cap, d, device=card, generator=g).to(dtype)
    dout = torch.randn(n, d, device=card, generator=g).to(dtype)
    from sm3x_torch.ops import moe_cuda as K

    for _ in range(2):
        assert torch.equal(K.moe_dispatch_cuda(x, smap.slot_assign, k),
                           moe.dispatch_plain(x, smap.slot_assign, k))
        assert torch.equal(K.moe_combine_cuda(y, gates, smap.token_slot),
                           moe.combine_plain(y, gates, smap.token_slot))
        dy, dg = K.moe_combine_backward_cuda(dout, y, gates,
                                             smap.slot_assign, k)
        pdy, pdg = moe.combine_backward_plain(dout, y, gates,
                                              smap.slot_assign,
                                              smap.token_slot)
        assert torch.equal(dy, pdy)
        torch.testing.assert_close(dg, pdg, rtol=1e-5, atol=1e-4)
        assert torch.equal(K.moe_dispatch_backward_cuda(y, smap.token_slot),
                           moe.dispatch_backward_plain(y, smap.token_slot))


def _card_run(tmp_path, graphed: bool) -> dict:
    from sm3x_torch.data.prefetch import wrap_from_config
    from sm3x_torch.data.synthetic import synthetic_paired_data

    cfg = _cfg(tmp_path, "cuda")
    cfg.optim.epochs = 2
    tr = bt.SSLTrainer(cfg)
    assert isinstance(tr.train_step, common.GraphedStep)
    if not graphed:
        tr.train_step = tr.train_step.eager
    data = wrap_from_config(synthetic_paired_data(24, canvas=48, seed=1),
                            tr.device, cfg.data)
    stats = [tr.train_epoch(data, e) for e in range(2)]
    torch.cuda.synchronize()
    state = [t.detach().clone() for p in tr.model.parameters()
             for t in (p, tr.optimizer.state[p]["exp_avg"])]
    return dict(stats=stats, state=state, trainer=tr)


@pytest.mark.cuda
def test_the_graphed_v_moe_step_is_the_eager_step(card, tmp_path):
    """Six steps of the toy V-MoE graphed against eager under
    deterministic algorithms: losses, drop counts, parameters and AdamW's
    first moments within four times two eager runs' own gap (bitwise
    where those are); six generators in the graph."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        eager = [_card_run(tmp_path / f"e{i}", False) for i in range(2)]
        graphed = _card_run(tmp_path / "g", True)
    finally:
        torch.use_deterministic_algorithms(was)
    assert len(graphed["trainer"].train_step.generators) == 6

    def flat(r):
        return [x for s in r["stats"] for x in
                s["step_losses"] + [s["moe_dropped"], s["moe_assignments"]]]

    def gap(a, b):
        return max(max(abs(x - y) for x, y in zip(flat(a), flat(b))),
                   max(float((x.double() - y.double()).abs().max())
                       for x, y in zip(a["state"], b["state"])))

    own, got = gap(eager[0], eager[1]), gap(eager[0], graphed)
    assert got <= 4 * own if own else got == 0.0, (got, own)


@pytest.mark.cuda
def test_the_v_moe_step_makes_no_host_sync(card, tmp_path):
    """After a first step, a step of the toy V-MoE under the synchronise
    debug mode 'error': routing, slot map, aux loss, K5, the experts and
    AdamW queue without one wait for the device."""
    tr = bt.SSLTrainer(_cfg(tmp_path, "cuda"))
    step = tr.train_step.eager
    canv, hw = _canvases("cuda", 0)
    step(canv, hw, canv.flip(1), hw, 1)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(canv, hw, canv.flip(1), hw, 2)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.isfinite(torch.stack(list(out.values()))).all()
