#!/usr/bin/env python
"""Where a bf16 stage-1 step rounds: a census of the roundings to bf16 in
the JAX package's compiled step or in the PyTorch port's step under
`amp`, on the CPU, for a ResNet-18 or a cut ViT (`vit_cut`: patch 16,
dim 128, depth 2, 2 heads) v32 model.

    python tools/bf16_census.py jax resnet18
    python tools/bf16_census.py torch resnet18
    python tools/bf16_census.py jax vit_cut --json out.json

One package a process (the port never imports JAX).

`jax`: the optimised CPU HLO of `make_ssl_train_step`'s step (augment,
forward, gradient, AdamW), as `jax.jit(...).lower(...).compile()` gives
it with the `XLA_FLAGS` of the environment. Every `convert` to bf16 that
survives is listed by the op it belongs to (the Flax module and
primitive in its `op_name`) and by whether it rounds (a later `convert`
back to float32 reads it) or stores a bf16 tensor; `forward` is under
`jvp(...)`, `gradient` under `transpose(jvp(...))`. The convolutions and
dots are counted by their operand types.

`torch`: the aten ops of one forward and backward of the port's model
and loss under `amp`, from a `TorchDispatchMode`: every op that returns
a bf16 tensor, by op, by pass, and by whether it rounds (arithmetic whose
result is rounded to bf16, a cast from float32) or is exact on bf16
values (relu, max-pool, views, copies).

Prints a table a site, then one JSON line (`--json PATH` writes it too).
"""

import argparse
import collections
import dataclasses
import json
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

B, SIZE, CANVAS, PROJ = 10, 64, 80, 64   # B unlike any kernel dimension
VIT_CUT = dict(patch=16, dim=128, depth=2, n_heads=2)

_INSTR = re.compile(r"^\s*(ROOT\s+)?%?([\w.\-]+) = (\w+)\[([\d,]*)\]\S*\s+"
                    r"([\w\-]+)\((.*)$")
_OPNAME = re.compile(r'op_name="([^"]*)"')


def parse_hlo(text: str):
    """({computation: {name: (dtype, shape, opcode, operands, op_name,
    is_root)}} of the array-valued instructions of an HLO module's text,
    {fused computation: (caller computation, fusion instruction)})."""
    comps, callers, cur, where = {}, {}, None, None
    for line in text.splitlines():
        called = re.search(r"calls=%?([\w.\-]+)", line)
        m = _INSTR.match(line)
        if called and m and cur is not None:
            callers[called.group(1)] = (where, m.group(2))
        if line.endswith("{") and "=" not in line.split("(")[0]:
            where = line.split()[1 if line.startswith("ENTRY") else 0]
            where = where.lstrip("%")
            cur = comps.setdefault(where, {})
            continue
        m = _INSTR.match(line)
        if m is None or cur is None:
            continue
        root, name, dtype, shape, opcode, rest = m.groups()
        args = rest.split(")", 1)[0]
        operands = re.findall(r"%([\w.\-]+)", args)
        op = _OPNAME.search(rest)
        cur[name] = (dtype, tuple(int(d) for d in shape.split(",") if d),
                     opcode, operands, op.group(1) if op else "",
                     bool(root))
    return comps, callers


def _source(comps, callers, comp, name):
    """The instruction a fusion's parameter stands for: the caller's
    operand, followed up through nested fusions; (opcode, op_name)."""
    instrs = comps[comp]
    while name in instrs and instrs[name][2] == "parameter":
        m = re.match(r"param_(\d+)", name)
        if m is None or comp not in callers:
            break
        comp, fusion = callers[comp]
        name = comps[comp][fusion][3][int(m.group(1))]
        instrs = comps[comp]
    src = instrs.get(name)
    if src is None:
        return "parameter", ""
    if src[2] == "fusion":
        return "fusion", src[4]
    return src[2], src[4]


def _site(op_name: str, shape, batch_rows) -> str:
    """A convert's site from its Flax module path and its operand's shape:
    `<module>: activation` or `<module>: weight`."""
    parts = [p for p in op_name.split("/") if p]
    mods = [p for p in parts[1:-1]
            if not p.startswith(("jvp(", "transpose("))]
    mods = [re.sub(r"_\d+$", "", p) for p in mods
            if p not in ("derm_backbone", "clinic_backbone")]
    where = "/".join(mods[-2:]) if mods else "(top)"
    role = "activation" if shape and shape[0] in batch_rows else "weight"
    if not shape:
        role = "scalar"
    return f"{where}: {role}"


def jax_census(arch: str) -> dict:
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from sm3x.models import vit as jax_vit
    from sm3x.models.simclr import build_ssl_model
    from sm3x.ops.augment import SSL_AUG
    from sm3x.train import common
    from sm3x.train.backbone_train import make_ssl_train_step

    if arch == "vit_cut":
        jax_vit.VIT_SPECS["vit_cut"] = VIT_CUT
        jax_vit.VIT_FEAT_DIMS["vit_cut"] = VIT_CUT["dim"]
        size = 32
    else:
        size = SIZE
    model, style = build_ssl_model(
        "v32", arch, PROJ, dtype=jnp.bfloat16,
        remat="flash" if arch == "vit_cut" else False)
    x = jnp.zeros((2, size, size, 3), jnp.float32)
    variables = model.init(jax.random.key(0), (x, x), (x, x), train=False)
    state = common.create_train_state(
        model, variables, common.make_adamw(1e-3, 5e-2, eps=1e-5))
    step = make_ssl_train_step(model, style, 0.1, 2, (0.5,) * 3, (0.25,) * 3,
                               dataclasses.replace(SSL_AUG,
                                                   out_size=(size, size)))
    canvas = jnp.zeros((B, CANVAS, CANVAS, 3), jnp.uint8)
    hw = jnp.full((B, 2), CANVAS, jnp.int32)
    text = step.lower(state, canvas, hw, canvas, hw,
                      jax.random.key(1)).compile().as_text()
    comps, callers = parse_hlo(text)
    tokens = (size // 16) ** 2 + 1
    batch_rows = {B, 2 * B, B * tokens, 2 * B * tokens}
    sites = collections.Counter()
    products = collections.Counter()
    for comp, instrs in comps.items():
        users = collections.defaultdict(list)
        for name, (_, _, _, operands, _, _) in instrs.items():
            for o in operands:
                users[o].append(name)
        for name, (dtype, shape, opcode, operands, op_name,
                   root) in instrs.items():
            if opcode in ("convolution", "dot"):
                kinds = ",".join(instrs[o][0] if o in instrs else "?"
                                 for o in operands[:2])
                products[f"{dtype} {opcode}({kinds})"] += 1
            if opcode != "convert" or dtype != "bf16" or not operands:
                continue
            src = instrs.get(operands[0])
            if src is not None and src[0] == "bf16":
                continue
            back = any(instrs[u][2] == "convert" and instrs[u][0] == "f32"
                       for u in users[name])
            kind = "rounds" if back else ("stores" if root else "feeds bf16")
            # a convert XLA inserted has no op_name: its operand's names it
            src_op, src_name = _source(comps, callers, comp, operands[0])
            op_name = op_name or src_name
            direction = "gradient" if "transpose(" in op_name else "forward"
            sites[(direction, _site(op_name, shape, batch_rows), src_op,
                   kind)] += 1
    rows = [dict(pass_=d, site=s, after=a, kind=k, converts=n)
            for (d, s, a, k), n in sorted(sites.items())]
    return {"package": "jax", "arch": arch,
            "xla_flags": os.environ.get("XLA_FLAGS", ""),
            "sites": rows, "products": dict(sorted(products.items()))}


# aten ops that are exact on bf16 values: their bf16 output holds the
# same numbers their inputs held
_EXACT = ("relu", "relu_", "threshold_backward", "max_pool2d_with_indices",
          "max_pool2d_with_indices_backward", "view", "_unsafe_view",
          "reshape", "permute", "transpose", "t", "expand", "slice",
          "select", "cat", "clone", "detach", "alias", "split",
          "split_with_sizes", "unsqueeze", "squeeze", "as_strided", "copy_",
          "new_empty_strided", "empty_like", "zeros_like", "zero_",
          "fill_", "unbind", "stack", "_reshape_alias", "contiguous",
          "neg", "new_zeros", "empty", "empty_strided", "zeros")


def torch_census(arch: str) -> dict:
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from sm3x_torch.losses.ssl import ssl_loss
    from sm3x_torch.models import vit
    from sm3x_torch.models.simclr import build_ssl_model

    if arch == "vit_cut":
        vit.VIT_SPECS["vit_cut"] = VIT_CUT
        vit.VIT_FEAT_DIMS["vit_cut"] = VIT_CUT["dim"]
        size, remat = 32, "flash"
    else:
        size, remat = SIZE, False
    torch.manual_seed(0)
    model, style = build_ssl_model("v32", arch, PROJ, amp=True, remat=remat,
                                   img_size=size)
    model.train()
    views = [torch.from_numpy(v) for v in np.random.default_rng(0)
             .standard_normal((4, B, size, size, 3)).astype(np.float32)]
    state = {"pass": "forward"}
    sites = collections.Counter()

    class Census(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            outs = [t for t in torch.utils._pytree.tree_leaves(out)
                    if isinstance(t, torch.Tensor)]
            if any(t.dtype == torch.bfloat16 for t in outs):
                ins = [t for t in torch.utils._pytree.tree_leaves(
                    (args, kwargs)) if isinstance(t, torch.Tensor)]
                name = func.overloadpacket.__name__
                from_f32 = any(t.dtype == torch.float32 for t in ins)
                if name in ("_to_copy", "to", "copy_") and from_f32:
                    kind = "rounds (cast from float32)"
                    role = ("activation" if ins[0].dim() and ins[0].shape[0]
                            in (B, 2 * B) else "weight")
                    name = f"{name}: {role}"
                elif name in _EXACT:
                    kind = "exact"
                else:
                    kind = "rounds"
                sites[(state["pass"], name, kind)] += 1
            return out

    with Census():
        outs = model(views[:2], views[2:])
        loss, _ = ssl_loss(outs, style, 0.1, 2)
        state["pass"] = "gradient"
        loss.backward()
    rows = [dict(pass_=p, site=s, kind=k, ops=n)
            for (p, s, k), n in sorted(sites.items())]
    return {"package": "torch", "arch": arch, "sites": rows}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("package", choices=("jax", "torch"))
    p.add_argument("arch", choices=("resnet18", "vit_cut"))
    p.add_argument("--json", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    out = (jax_census if args.package == "jax" else torch_census)(args.arch)
    count = "converts" if args.package == "jax" else "ops"
    for r in out["sites"]:
        print(f"{r['pass_']:9s} {r['site']:40s} {r.get('after', ''):16s} "
              f"{r['kind']:28s} {r[count]:5d}")
    for k, n in out.get("products", {}).items():
        print(f"products  {k:48s} {n:5d}")
    line = json.dumps(out)
    print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    return out


if __name__ == "__main__":
    main()
