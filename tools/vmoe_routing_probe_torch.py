#!/usr/bin/env python3
"""Readings of V-MoE-B/16's routing in the benchmark cell
`vmoe_b16_ssl_recipe`, on one CUDA card: why the seeded routers send most
choices past capacity, what the router's first gradient is made of, and
what the program's run routes with its routers started at zero.

    python3 tools/vmoe_routing_probe_torch.py --seed 2147483811 \\
        --out vmoe_probe.json

1. `run`: the program's run of the cell as configured (routers at zero):
   each epoch's share of dropped choices through a 51 s window, and K5's
   launches a step of the graphed step in one traced epoch.
2. `routing`: the cell's first derm view (step 0, view 1) through the
   float32 reference's encoder on the seeded weights; for each MoE block the
   share of the LN2 tokens' energy in their mean token, their mean cosine
   with it, and the share of choices dropped (a) as routed, (b) with the
   router fed the tokens less their mean, (c) with the view's per-channel
   mean taken out of the input, (d) with the router at zero (noise alone).
3. `router_grad`: the routers' first gradient by term, the features'
   (against a fixed random feature gradient), L_imp's and L_load's, of the
   port (bf16 autocast, flash attention) against the reference (float32,
   TF32 off) on that call, the same weights, view and noise: the worst
   router's |g_port - g_ref| / |g_ref|, and the terms' norms, with the
   seeded routers and with the routers at zero; and for each MoE block the
   share of tokens whose top-k choices the two sides made apart, and of
   choices that one side kept and the other dropped.
"""

import argparse
import contextlib
import json
import os
import sys

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL = "vmoe_b16_ssl_recipe"
K5 = {"dispatch_fwd": r"moe_dispatch_fwd_kernel",
      "combine_fwd": r"moe_combine_fwd_kernel",
      "combine_bwd": r"moe_combine_bwd_kernel",
      "dispatch_bwd": r"moe_dispatch_bwd_kernel"}


def program_run(cell, stage, seed: int, seconds: float, dev: str) -> dict:
    run = stage.Run(cell, seed, dev)
    shares = []
    epoch = run._epoch

    def logged(e):
        stat = epoch(e)
        shares.append(stat["moe_dropped"] / stat["moe_assignments"])
        return stat

    run._epoch = logged
    run.build()
    run.first_epoch()
    run.window(seconds, trace=True)
    sl = run.tracer.slice
    out = dict(dropped_share_by_epoch=shares, traced_steps=sl.steps,
               launches_per_step=len(sl.kernels) / sl.steps,
               k5_launches_per_step={k: len(sl.matching(p)) / sl.steps
                                     for k, p in K5.items()})
    run.free()
    return out


def dropped_share(logits, noise, k: int, cap: int) -> float:
    experts = logits.shape[1]
    top = (logits + noise).softmax(-1).topk(k, dim=-1).indices
    counts = top.flatten().bincount(minlength=experts)
    return float((counts - cap).clamp(min=0).sum()) / top.numel()


@contextlib.contextmanager
def recorded(module, name: str, into: list):
    """`module.name` (a squared-CV function) records each value it gives."""
    fn = getattr(module, name)

    def rec(v):
        out = fn(v)
        into.append(out)
        return out

    setattr(module, name, rec)
    try:
        yield
    finally:
        setattr(module, name, fn)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=51.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    sys.path.insert(0, CHECKOUT)
    import torch

    from portbench.harness import spec
    from portbench.harness.inputs import paired_split
    from portbench.reference import prng
    from portbench.reference import vmoe as ref_vmoe
    from portbench.reference.train import _tf32, build_model, views
    from sm3x_torch.models import vmoe
    from sm3x_torch.ops import moe as moe_ops

    cell = spec.load_cell(CELL)
    stage = spec.load_stage(cell)
    c, m, t = cell.config, cell.config["moe"], cell.traffic
    dev = args.device
    result = {"seed": args.seed,
              "run": program_run(cell, stage, args.seed, args.seconds, dev)}
    print(json.dumps({"run": result["run"]}), flush=True)

    # the cell's first derm view and its router noise, as the reference
    # draws them
    _tf32(False, False)
    split = paired_split(t["cases"], t["canvas"], args.seed)
    rows = prng.batch_rows(prng.epoch_order(t["cases"], args.seed, 0),
                           cell.batch, 0)
    s = prng.step_seed(args.seed, 0, 0)
    x = views(cell, prng.fold_in(s, 0),
              torch.from_numpy(split["derm"][rows]).to(dev),
              torch.from_numpy(split["derm_hw"][rows]).to(dev))[0]
    tokens = cell.batch * ((c["img_size"] // c["patch"]) ** 2 + 1)
    cap = max(1, int(round(m["k"] * tokens * m["capacity_ratio"]
                           / m["experts"])))

    def noise():
        gen = ref_vmoe.router_generators(s, dev)[0]
        return ref_vmoe.noises(gen, 2, tokens, m["experts"],
                               len(m["blocks"]), dev)[0]

    model = build_model(cell, args.seed, dev)
    ref = model.derm_backbone.encoder
    layers = [getattr(ref, f"block{i}").moe for i in m["blocks"]]
    seen = []
    hooks = [lay.register_forward_pre_hook(
        lambda mod, a: seen.append((a[0].detach(), a[1]))) for lay in layers]
    with torch.no_grad():
        ref(x, noise())
        routed = list(seen)
        seen.clear()
        ref(x - x.mean(dim=(0, 1, 2), keepdim=True), noise())
        centred_input = list(seen)
    for h in hooks:
        h.remove()
    blocks = []
    for lay, (h, nz), (hc, _) in zip(layers, routed, centred_input):
        flat, w = h.reshape(-1, h.shape[-1]), lay.router.weight.detach()
        mean = flat.mean(0)
        blocks.append(dict(
            common_energy=float(mean.square().sum()
                                / flat.square().sum(1).mean()),
            cosine_to_mean=float(torch.nn.functional.cosine_similarity(
                flat, mean[None], dim=1).mean()),
            dropped_routed=dropped_share(flat @ w.t(), nz, m["k"], cap),
            dropped_router_input_centred=dropped_share(
                (flat - mean) @ w.t(), nz, m["k"], cap),
            dropped_input_centred=dropped_share(
                hc.reshape(-1, h.shape[-1]) @ w.t(), nz, m["k"], cap),
            dropped_router_zero=dropped_share(
                torch.zeros_like(flat @ w.t()), nz, m["k"], cap)))
    result["routing"] = dict(zip(map(str, m["blocks"]), blocks))
    print(json.dumps({"routing": result["routing"]}), flush=True)
    del routed, centred_input, seen

    # the routers' first gradient by term
    with torch.device(dev):
        port = vmoe.build_vmoe(c["arch"], img_size=c["img_size"],
                               remat=c["use_checkpoint"])
    port.load_state_dict(ref.state_dict())
    del model
    port.train()
    g_feat = torch.randn(cell.batch, c["feat_dim"], device=dev,
                         generator=torch.Generator(dev).manual_seed(1)) \
        / cell.batch
    n_moe = len(m["blocks"])

    def terms(enc, call, routers, module, name):
        cvs = []
        with recorded(module, name, cvs):
            feat = call()
        imp = torch.stack(cvs[0::2]).mean()
        load = torch.stack(cvs[1::2]).mean()
        assert len(cvs) == 2 * n_moe
        out = {}
        for term, val in (("features", (feat.float() * g_feat).sum()),
                          ("importance", imp), ("load", load)):
            out[term] = torch.autograd.grad(val, routers, retain_graph=True,
                                            allow_unused=True)
        return out

    def port_call():
        with vmoe.routing(port, [ref_vmoe.router_generators(s, dev)[0]]), \
                torch.autocast(dev, dtype=torch.bfloat16):
            return port(x)

    def choices_apart() -> list:
        port_maps, ref_in = [], []
        slot_map = moe_ops.slot_map

        def kept(ch, e, c_):
            out = slot_map(ch, e, c_)
            port_maps.append((ch, out.token_slot))
            return out

        hooks = [getattr(ref, f"block{i}").moe.register_forward_pre_hook(
            lambda mod, a: ref_in.append((a[0].detach(), a[1],
                                          mod.router.weight.detach())))
            for i in m["blocks"]]
        moe_ops.slot_map = kept
        try:
            with torch.no_grad():
                port_call()
                ref(x, noise())
        finally:
            moe_ops.slot_map = slot_map
            for hk in hooks:
                hk.remove()
        out = []
        for (pc, pts), (h, nz, w) in zip(port_maps, ref_in):
            logits = torch.nn.functional.linear(h.reshape(-1, h.shape[-1]), w)
            rc = (logits + nz).softmax(-1).topk(m["k"], dim=-1).indices
            rts = slot_map(rc, m["experts"], cap).token_slot
            out.append(dict(
                tokens_rerouted=float((pc != rc).any(1).float().mean()),
                kept_apart=float(((pts >= 0) != (rts >= 0)).float().mean())))
        return out

    grads, apart = {}, {}
    for init in ("seeded", "zero"):
        if init == "zero":
            with torch.no_grad():
                for enc in (ref, port):
                    for i in m["blocks"]:
                        getattr(enc, f"block{i}").moe.router.weight.zero_()
        r_routers = [getattr(ref, f"block{i}").moe.router.weight
                     for i in m["blocks"]]
        p_routers = [getattr(port, f"block{i}").moe.router.weight
                     for i in m["blocks"]]
        apart[init] = choices_apart()
        print(json.dumps({"apart": {init: apart[init]}}), flush=True)
        want = terms(ref, lambda: ref(x, noise())[0], r_routers, ref_vmoe,
                     "cv2")
        got = terms(port, port_call, p_routers, moe_ops, "_cv2")
        per = {}
        for term in want:
            gaps, norms = [], []
            for a, b in zip(got[term], want[term]):
                a = torch.zeros_like(b) if a is None else a
                nb = float(b.norm())
                norms.append(nb)
                gaps.append(float((a.float() - b).norm()) / nb if nb > 0
                            else None)
            per[term] = dict(worst_gap=max((g for g in gaps if g is not None),
                                           default=None),
                             gaps=gaps, ref_norms=norms)
        grads[init] = per
        print(json.dumps({"router_grad": {init: per}}), flush=True)
    result["router_grad"], result["apart"] = grads, apart
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
