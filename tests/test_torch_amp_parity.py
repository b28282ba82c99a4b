"""The port's bf16 (`amp`) ResNet path against the JAX package's, on the
CPU, on shared weights: ResNet-18 v32 at 64 x 64, B = 16, seeded numpy
views, train mode, one forward and backward.

The weights are the port's initial ones (`torch.manual_seed(0)`), read
into the JAX package's tree by its own `sm3x.utils.torch_convert`. The
JAX package's program is its jitted bf16 forward and gradient with the
default XLA flags (none is set here). The float64 reference is the port's
own step in float64, which `tests/test_torch_train_step.py` holds to the
JAX package's float64 step (loss rtol 1e-5); a float64 JAX compile would
double this file's time. Held, for the stage-1 model: the encoder
features, the intra and cross projections, the projectors' float32
arithmetic, the loss and every parameter's gradient; and the train-mode
features of a stage-2 `DualExtractor` and of a supervised `Baseline` on
the same encoders, against the stage-1 step's features of those views.

The two bf16 programs round in different places (`tools/bf16_census.py`):
the JAX package's CPU program keeps each convolution's output, the
batch-norm statistics taken from it and the weight gradients in float32,
where the port's autocast convolution returns bf16 and batch norm
normalises the rounded values. So the two are held to each other loosely,
and each to float64 by the ratio of their errors. Bounds, with the
values measured when they were set (relative L2 errors):

- the port's error against float64 is between 0.5 and 1.5 times the JAX
  package's: features 2.54e-2 against 2.03e-2 (1.25x), projections
  8.62e-2 against 6.91e-2 (1.25x), the stage-2 and baseline features
  1.25x. Below 0.5 the encoders ran in another precision than bf16;
- the port against the JAX package's bf16: features within 4e-2
  (2.76e-2; 2.77e-2 through `DualExtractor` and `Baseline`),
  projections within 1.2e-1 (9.41e-2);
- the projectors, fed the port's own bf16-step features, within 1e-4 of
  float64 (1.1e-6): they compute in float32;
- the loss within 2e-2 of float64 (5.6e-3) and of the JAX package's
  bf16 loss (4.8e-3);
- each parameter's gradient has a cosine of at least 0.7 with the JAX
  package's bf16 gradient (lowest 0.734, `derm_backbone.encoder.layer1.0.
  bn1.bias`; 0.73-0.83 over four draws of the views), and the port's
  mean cosine with float64 is at most 0.05 below the JAX package's
  (0.9145 against 0.9324). Early batch-norm parameters' gradients are
  sums that cancel: the JAX package's own bf16 gradient has a cosine of
  0.83-0.87 with float64 at its worst tensor.

What they guard, each checked on a broken copy: autocast left off the
encoders, or put on the intra or the cross projectors, and the encoders
run in float16. Each fails at least one test here.
"""

import copy
import ctypes
import gc

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from sm3x.losses.ssl import ssl_loss as jax_ssl_loss
from sm3x.models.simclr import build_ssl_model as jax_build_ssl_model
from sm3x.utils import torch_convert
from sm3x_torch.losses.ssl import ssl_loss
from sm3x_torch.models.baseline import Baseline
from sm3x_torch.models.mlc import DualExtractor
from sm3x_torch.models.simclr import build_ssl_model
from sm3x_torch.utils import weights

torch.set_num_threads(2)

B, SIZE, PROJ, T, GROUPS = 16, 64, 64, 0.1, 2
ENCODERS = ("derm_backbone", "clinic_backbone")

# the port's error over the JAX package's, both against float64
LOW_RATIO, ERROR_RATIO = 0.5, 1.5
# the port against the JAX package's bf16, relative L2
FEATURES_TO_JAX, PROJECTIONS_TO_JAX = 4e-2, 1.2e-1
# the port's projectors on its own features against float64's
PROJECTOR_TO_F64 = 1e-4
# the loss, relative
LOSS_TO_F64 = LOSS_TO_JAX = 2e-2
# the cosine of a gradient with the JAX package's bf16 one, and the mean
# cosine with float64's below the JAX package's by at most
GRAD_COSINE, GRAD_MEAN_GAP = 0.7, 0.05


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _cosine(a, b) -> float:
    a, b = np.ravel(a).astype(np.float64), np.ravel(b).astype(np.float64)
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b)))


def _outputs(outs, feats):
    """The named tensors a step is held on: each encoder view's feature,
    the intra projections and each cross projection."""
    out = {"derm_z": outs["derm_z"], "clinic_z": outs["clinic_z"]}
    for key in ("cross_derm_z", "cross_clinic_z"):
        for i, z in enumerate(outs[key]):
            out[f"{key}{i}"] = z
    for mod, fs in feats.items():
        for i, f in enumerate(fs):
            out[f"{mod}.f{i}"] = f
    return out


def _port_step(model, style, views):
    """The named outputs (`_outputs`), the loss and every parameter's
    gradient of one train-mode forward and backward of a port model."""
    feats = {mod: [] for mod in ENCODERS}
    hooks = [getattr(model, mod).encoder.register_forward_hook(
        lambda m, i, o, mod=mod: feats[mod].append(o)) for mod in ENCODERS]
    v = [torch.from_numpy(a) for a in views]
    try:
        outs = model((v[0], v[1]), (v[2], v[3]))
    finally:
        for h in hooks:
            h.remove()
    loss, _ = ssl_loss(outs, style, T, GROUPS)
    loss.backward()
    named = {k: t.detach().double().numpy()
             for k, t in _outputs(outs, feats).items()}
    grads = {k: p.grad.double().numpy() for k, p in model.named_parameters()}
    return named, float(loss.detach()), grads


def _port_model(sd, amp):
    model, style = build_ssl_model("v32", "resnet18", PROJ, amp=amp,
                                   img_size=SIZE)
    model.load_state_dict(weights.to_tensors(sd), strict=True)
    return model.train(), style


@pytest.fixture(scope="module", autouse=True)
def _release_memory():
    """After the module, drop the compiled programs and hand the freed
    heap back: the suite's workers share one machine's memory."""
    yield
    jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


@pytest.fixture(scope="module")
def reference():
    """The shared weights and views; the JAX package's bf16 step and the
    float64 step on them."""
    torch.manual_seed(0)
    model, style = build_ssl_model("v32", "resnet18", PROJ, img_size=SIZE)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    params, stats = torch_convert.convert_simclr_skin(sd, "resnet18")
    views = np.random.default_rng(0).standard_normal(
        (4, B, SIZE, SIZE, 3)).astype(np.float32)

    jm, jax_style = jax_build_ssl_model("v32", "resnet18", PROJ,
                                        dtype=jnp.bfloat16)
    assert jax_style == style

    def loss_fn(params, views):
        outs, mut = jm.apply(
            {"params": params, "batch_stats": stats},
            (views[0], views[1]), (views[2], views[3]), train=True,
            mutable=["batch_stats", "intermediates"],
            capture_intermediates=lambda m, name: (m.name == "encoder"
                                                   and name == "__call__"))
        total, _ = jax_ssl_loss(outs, style, T, GROUPS)
        feats = {mod: mut["intermediates"][mod]["encoder"]["__call__"]
                 for mod in ENCODERS}
        return total, (outs, feats)

    (loss, (outs, feats)), grads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params, jnp.asarray(views))
    grads = weights.simclr_skin_state_dict(jax.tree.map(np.asarray, grads),
                                           stats)
    bf16 = ({k: np.asarray(v, np.float64)
             for k, v in _outputs(outs, feats).items()}, float(loss), grads)

    model64, _ = _port_model(sd, amp=False)
    f64 = _port_step(model64.double(), style, views.astype(np.float64))
    return dict(sd=sd, style=style, views=views, bf16=bf16, f64=f64)


@pytest.fixture(scope="module")
def port(reference):
    """The port's bf16 step on the same weights and views, and its
    projectors run again in float64 on the features that step made."""
    model, style = _port_model(reference["sd"], amp=True)
    named, loss, grads = _port_step(model, style, reference["views"])
    f = {k: torch.from_numpy(v) for k, v in named.items() if ".f" in k}
    again = {}
    with torch.no_grad():
        for i, mod in enumerate(ENCODERS):
            intra = copy.deepcopy(getattr(model, mod).projector).double()
            views = (f[f"{mod}.f0"], f[f"{mod}.f1"])
            again[mod.split("_")[0] + "_z"] = intra(torch.cat(views, dim=0))
            cross = copy.deepcopy(model.cross_proj[i]).double()
            for j, v in enumerate(views):
                again[f"cross_{mod.split('_')[0]}_z{j}"] = cross(v)
    return named, loss, grads, {k: v.numpy() for k, v in again.items()}


def _errors(reference, port, keys):
    """(the port's error, the JAX package's error, the port against the
    JAX package's bf16) over the named tensors `keys`."""
    want64, want16, got = (reference["f64"][0], reference["bf16"][0],
                           port[0])
    stack = lambda d: np.concatenate([d[k].ravel() for k in keys])
    return (_rel(stack(got), stack(want64)), _rel(stack(want16),
                                                  stack(want64)),
            _rel(stack(got), stack(want16)))


def _keys(port, features: bool):
    return [k for k in port[0] if (".f" in k) == features]


def test_features_as_precise_as_the_jax_package(reference, port):
    mine, theirs, between = _errors(reference, port, _keys(port, True))
    assert LOW_RATIO * theirs <= mine <= ERROR_RATIO * theirs, (mine, theirs)
    assert between <= FEATURES_TO_JAX, between


def test_projections_as_precise_as_the_jax_package(reference, port):
    mine, theirs, between = _errors(reference, port, _keys(port, False))
    assert LOW_RATIO * theirs <= mine <= ERROR_RATIO * theirs, (mine, theirs)
    assert between <= PROJECTIONS_TO_JAX, between


def test_projectors_stay_float32(port):
    """The projectors, fed the bf16 step's own features, as in float64."""
    named, again = port[0], port[3]
    assert set(again) == set(_keys(port, False))
    for k, want in again.items():
        assert _rel(named[k], want) <= PROJECTOR_TO_F64, k


def test_loss_as_precise_as_the_jax_package(reference, port):
    want64, want16, got = (reference["f64"][1], reference["bf16"][1],
                           port[1])
    assert abs(got - want64) <= LOSS_TO_F64 * abs(want64), (got, want64)
    assert abs(got - want16) <= LOSS_TO_JAX * abs(want16), (got, want16)


def test_every_gradient_points_as_the_jax_package_s(reference, port):
    want16, want64, got = (reference["bf16"][2], reference["f64"][2],
                           port[2])
    assert set(got) == set(want64) and set(got) <= set(want16)
    to_jax = {k: _cosine(g, want16[k]) for k, g in got.items()}
    worst = min(to_jax, key=to_jax.get)
    assert to_jax[worst] >= GRAD_COSINE, (worst, to_jax[worst])
    mine = np.mean([_cosine(g, want64[k]) for k, g in got.items()])
    theirs = np.mean([_cosine(want16[k], want64[k]) for k in got])
    assert mine >= theirs - GRAD_MEAN_GAP, (mine, theirs)


@pytest.mark.parametrize("which", ["DualExtractor", "Baseline"])
def test_stage2_and_baseline_features_under_amp(reference, port, which):
    """Train-mode features of the derm view 0 and the clinic view 0 (a
    `DualExtractor` and a `Baseline` on the stage-1 model's encoders)
    against the stage-1 step's encoder features of the same views."""
    sd = reference["sd"]
    if which == "DualExtractor":
        model = DualExtractor("resnet18", amp=True, img_size=SIZE)
        prefix = "{}.encoder."
    else:
        model = Baseline("resnet18", amp=True, img_size=SIZE)
        prefix = "{}."
    mine = {}
    for mod in ENCODERS:
        src = f"{mod}.encoder."
        mine.update({prefix.format(mod) + k[len(src):]: v
                     for k, v in sd.items() if k.startswith(src)})
    missing, unexpected = model.load_state_dict(weights.to_tensors(mine),
                                                strict=False)
    assert not unexpected and all(k.startswith("classifier.")
                                  for k in missing)
    d, c = (torch.from_numpy(reference["views"][i]) for i in (0, 2))
    with torch.no_grad():
        if which == "DualExtractor":
            got = model.train()(d, c)
        else:
            got = torch.cat(model.extract(d, c, train=True), dim=1)
    assert got.dtype == torch.float32 and got.shape == (B, 2 * 512)
    keys = [f"{mod}.f0" for mod in ENCODERS]
    want64, want16 = (np.concatenate([ref[0][k] for k in keys], axis=1)
                      for ref in (reference["f64"], reference["bf16"]))
    mine, theirs = _rel(got, want64), _rel(want16, want64)
    assert LOW_RATIO * theirs <= mine <= ERROR_RATIO * theirs, (mine, theirs)
    assert _rel(got, want16) <= FEATURES_TO_JAX
