"""The port's Xception against the benchmark's plain reference
(``port_bench/reference/xception.py``) on seeded random weights, in
float32 on the CPU: full widths at 71² (Keras's smallest input), B=4 and
2 middle blocks (``xception_small``).

Compared: the eval log-probs, the train-mode log-probs and loss with a
fixed dropout draw, every leaf's first gradient, the moved BatchNorm
statistics and the parameters after three adamw steps. Each tolerance is
written with its reason; the same comparisons with the port computing in
bf16 fail them. The reference loads neither JAX nor the port, and the
port's separable-conv counter reads 34 a forward at the published
depth."""

import json
import subprocess
import sys

import pytest
import torch

from port_bench.reference import preprocess as rpre
from port_bench.reference import xception as ref
from port_bench.reference.precision import EXACT
from port_bench.reference.train import Batch, train_steps
from port_bench.tests.tiny import ROOT
from skin_image_analysis_tpu_torch.config import ModelConfig
from skin_image_analysis_tpu_torch.models.cnn import build_model
from skin_image_analysis_tpu_torch.models.xception import SeparableConv
from skin_image_analysis_tpu_torch.train.state import AdamW
from skin_image_analysis_tpu_torch.train.step import masked_loss_and_metrics
from tests.test_torch_pooling import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SIDE, FRAME, B, STEPS = 71, 80, 4, 3
SPEC = json.loads((ROOT / "port_bench" / "configs" / "xception.json")
                  .read_text())
CFG = dict(SPEC["model"], middle_blocks=2, image_size=SIDE)

# Tolerances, float32 against float32. In parentheses the float32 port's
# readings at this seed and at another (seed 1), then the bf16 port's:
#: eval log-probs, abs: the same operations in the same order, the
#: running statistics normalizing (0, 0; bf16 8.4e-3)
EVAL_TOL = 1e-5
#: train-mode log-probs, abs: the port's batch variance is E[x^2] - E[x]^2,
#: the reference's two-pass (9.5e-7, 1.4e-6; bf16 1.2e-2)
TRAIN_TOL = 2e-5
#: the first loss, relative (6.4e-8, 1.1e-7; bf16 5.2e-4), and the worst
#: of the three steps' after adamw's moves, in which elements whose
#: gradients are round-off move by +-lr either way (8.6e-5, 2.0e-5; bf16
#: 6.0e-4)
FIRST_LOSS_TOL, LOSS_TOL = 1e-5, 3e-4
#: a leaf's first gradient, norm of the difference over the reference's
#: norm: the variance formulas part by round-off, and the backward through
#: 22 BatchNorms of 4 rows can magnify it (3.9e-6, 1.5e-3 in the stem and
#: block 2, 3e-6 there with the reference's variance taken as the port's;
#: bf16 0.27)
GRAD_TOL = 1e-2
#: a BatchNorm statistic's 3-step change, the same ratio (5.3e-4, 6.6e-4;
#: bf16 2.5e-2)
STATS_TOL = 5e-3
#: a parameter's 3-step change, the same ratio: adam's first update is
#: +-lr wherever a gradient is nonzero, so elements whose gradients are
#: round-off flip their sign with it (0.042, 0.038; bf16 0.49)
DELTA_TOL = 0.1


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    d = torch.linalg.vector_norm((a - b).double())
    return float(d / torch.linalg.vector_norm(b.double()).clamp_min(1e-30))


@pytest.fixture(scope="module")
def case():
    """The reference's three adamw steps from seeded weights, rows and
    draws, and the weights, arena, batches and draws they came from."""
    torch.set_num_threads(1)
    g = torch.Generator().manual_seed(11)
    weights = ref.init(CFG, g, "cpu")
    arena = torch.randint(0, 256, (12, 3, FRAME, FRAME), dtype=torch.uint8,
                          generator=g)
    batches, draws = [], []
    for _ in range(STEPS):
        batches.append(Batch(torch.randint(0, 12, (B,), generator=g),
                             torch.randint(0, 7, (B,), generator=g),
                             torch.ones(B, dtype=torch.bool)))
        draws.append(rpre.draw_step(g, B, FRAME, SIDE, SPEC["augment"],
                                    ref.dropout_widths(CFG)))
    done = train_steps(ref, CFG, weights, arena, batches, draws, None,
                       SPEC["optim"], EXACT)
    return weights, arena, batches, draws, done


def _port(weights, dtype: str):
    model = build_model(ModelConfig(name="xception_small", num_classes=7,
                                    image_size=SIDE, compute_dtype=dtype),
                        device="cpu")
    model.load_state_dict(weights, strict=True)
    return model


def _readings(case, dtype: str) -> dict:
    """The port's readings of the same steps at compute dtype ``dtype``:
    eval and first train log-probs, losses, first gradients, the state
    after the three adamw steps."""
    weights, arena, batches, draws, _ = case
    model = _port(weights, dtype)
    x0 = rpre.train_batch(arena, batches[0].rows, draws[0], SIDE, True)
    with torch.no_grad():
        eval_lp = model(x0, train=False)
    names = [n for n, _ in model.named_parameters()]
    params = list(model.parameters())
    opt = AdamW(params, SPEC["optim"]["learning_rate"],
                SPEC["optim"]["weight_decay"])
    losses, first = [], None
    for batch, d in zip(batches, draws):
        x = rpre.train_batch(arena, batch.rows, d, SIDE, True)
        lp = model(x, train=True, dropout_noise=d.noise)
        loss = masked_loss_and_metrics(lp, batch.labels, batch.valid)[0]
        grads = torch.autograd.grad(loss, params)
        if first is None:
            first = (lp.detach(), dict(zip(names, grads)))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            opt.step(grads)
    return {"eval": eval_lp, "train": first[0],
            "grads": first[1], "losses": losses,
            "state": model.state_dict(), "x0": x0}


def _gaps(case, port) -> dict[str, float]:
    """Each compared number of the port against the reference."""
    weights, arena, batches, draws, done = case
    x0 = port["x0"]
    want_eval, _ = ref.forward(CFG, weights, x0, None, train=False)
    want_train, _ = ref.forward(CFG, weights, x0, draws[0].noise,
                                train=True)
    sd = port["state"]
    moved = {n: _rel(sd[n] - weights[n], done.params[n] - weights[n])
             for n in weights}
    return {
        "eval": float((port["eval"] - want_eval).abs().max()),
        "train": float((port["train"] - want_train).abs().max()),
        "first_loss": abs(port["losses"][0] - done.losses[0])
        / abs(done.losses[0]),
        "loss": max(abs(a - b) / abs(b)
                    for a, b in zip(port["losses"], done.losses)),
        "grad": max(_rel(port["grads"][n], g)
                    for n, g in done.first_grads.items()),
        "stats": max(v for n, v in moved.items() if ref.is_statistic(n)),
        "delta": max(v for n, v in moved.items()
                     if not ref.is_statistic(n)),
    }


@pytest.fixture(scope="module")
def f32(case):
    return _readings(case, "float32")


@pytest.fixture(scope="module")
def f32_gaps(case, f32):
    return _gaps(case, f32)


LIMITS = {"eval": EVAL_TOL, "train": TRAIN_TOL, "first_loss":
          FIRST_LOSS_TOL, "loss": LOSS_TOL, "grad": GRAD_TOL,
          "stats": STATS_TOL, "delta": DELTA_TOL}


@pytest.mark.parametrize("number", sorted(LIMITS))
def test_float32_port_agrees_with_the_reference(case, f32, f32_gaps,
                                               number):
    assert set(case[4].first_grads) == set(f32["grads"])
    assert f32_gaps[number] < LIMITS[number], f32_gaps


def test_a_bf16_port_fails_the_tolerances(case):
    gaps = _gaps(case, _readings(case, "bfloat16"))
    failed = {k for k, v in gaps.items() if v >= LIMITS[k]}
    # the forward's rounding alone shows in every number but the losses
    # after the first (adamw's sign-like first update hides it there)
    assert failed >= {"eval", "train", "first_loss", "grad", "stats",
                      "delta"}, gaps


def test_reference_parameters_are_keras_xceptions():
    """20,821,295 trainable parameters at the published depth, the head's
    14,343 among them; the state_dict's names and shapes are the
    port's."""
    cfg = dict(SPEC["model"])
    shapes = ref.shapes(cfg)
    learn = {n: s for n, s in shapes.items() if not ref.is_statistic(n)}
    assert sum(torch.Size(s).numel() for s in learn.values()) == 20_821_295
    assert sum(torch.Size(s).numel() for n, s in learn.items()
               if n.startswith("head.")) == 14_343
    model = build_model(ModelConfig(name="xception", num_classes=7,
                                    image_size=299), device="meta")
    assert {n: tuple(t.shape) for n, t in model.state_dict().items()} == \
        shapes


def test_importing_the_reference_loads_no_jax_nor_the_port():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import port_bench.reference.xception\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & {'jax', 'jaxlib', 'flax', 'optax',\n"
            "      'skin_image_analysis_tpu',\n"
            "      'skin_image_analysis_tpu_torch'}))\n" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"


def test_the_separable_conv_counter_reads_34_a_forward():
    model = build_model(ModelConfig(name="xception", num_classes=7,
                                    image_size=SIDE,
                                    compute_dtype="float32"), device="cpu")
    x = torch.zeros(1, SIDE, SIDE, 3)
    SeparableConv.calls = 0
    with torch.no_grad():
        model(x, train=False)
    assert SeparableConv.calls == 34
    with torch.no_grad():
        model(x, train=False)
    assert SeparableConv.calls == 68
