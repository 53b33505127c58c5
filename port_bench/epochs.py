"""What every driver shares: a cell's set-up, its epochs and the
readings the comparison judges.

A driver (``port_bench/drivers/<name>.py``) subclasses :class:`Cell`
with the calls that one of the program's epoch loops makes, in the same
order and without its file writes: ``build`` (the train state and the
preprocess functions, as the loop derives them from its config),
``train_calls`` (one epoch's multi-step train calls over an order),
``fetch`` (the loop's one fetch of the step metrics) and ``audit`` (the
loop's per-epoch audit over the whole test arena).

Set-up (:meth:`Cell.setup`) makes the cohort and the benchmark's weights
from the seed, loads the weights into the program's model, runs the
audit once on them (its outputs kept for the comparison), reseeds the
train state's generator and drives the first three train steps through
the window's own call: one call with one live step, then one with two,
the rest of each call inert padding. From these it keeps the losses, the
first gradient as the optimizer holds it (adam's first moment after one
step is ``(1 - b1) g``), the parameters' and the BatchNorm statistics'
change after three steps, and the first step's model input. The same
train state then runs the window.
"""

from __future__ import annotations

import gc
from typing import NamedTuple

import numpy as np
import torch

from port_bench import traffic
from port_bench.spans import PreprocessProbe, Spans

#: offsets of the seeds the benchmark derives from a run's seed
WEIGHTS_SEED, DRAWS_SEED = 0x5EED0001, 0x5EED0002
VERIFY_STEPS = 3


def derived_seed(seed: int, offset: int) -> int:
    return (seed + offset) % 2**63


def norm(t: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(t.detach().double()))


class Readings(NamedTuple):
    """What the comparison judges, from the program or from a reference."""

    losses: list                  # the first three steps' losses
    grad_norms: dict              # trained leaf -> norm of its 1st gradient
    delta_norms: dict             # parameter -> norm of its 3-step change
    stat_norms: dict              # statistic -> norm of its 3-step change
    inputs: torch.Tensor          # the first step's model input, NHWC
    log_probs: torch.Tensor       # the audit's [N_test, C] log-probs
    record: dict                  # the audit's record


class Epoch(NamedTuple):
    images: int                   # rows of the live steps
    steps: int                    # live steps
    bad_steps: int                # live steps with a non-finite loss


class Cell:
    """One cell's program side. ``spec`` holds the cell's ``config``,
    ``traffic`` and ``workload`` files."""

    reference = None              # the reference model module

    def __init__(self, spec: dict, seed: int, device) -> None:
        self.spec = spec
        self.model_cfg = spec["config"]["model"]
        self.seed = seed
        self.device = torch.device(device)
        self.batch = spec["traffic"]["batch_size"]
        self.spans = Spans()
        self.probe = PreprocessProbe(self.spans)
        self.order_rng = np.random.default_rng(seed + 1)
        self.state = None

    # -- the driver's part ---------------------------------------------
    def build(self) -> None:
        """Set ``state``, ``train_pre``, ``eval_pre``, ``class_weights``
        and ``k`` (steps a call) as the program's loop derives them."""
        raise NotImplementedError

    def train_calls(self, order: np.ndarray) -> list[dict]:
        raise NotImplementedError

    def fetch(self, metrics: list[dict]) -> Epoch:
        raise NotImplementedError

    def audit(self, capture: bool = False):
        """The loop's audit; with ``capture``, (record, the model's
        ``[N_test, C]`` eval log-probs in row order)."""
        raise NotImplementedError

    # -- shared ----------------------------------------------------------
    def next_order(self) -> np.ndarray:
        """The next epoch's rows: one shuffle of ``default_rng(seed +
        1)``, as the program's loops draw it."""
        order = np.arange(self.cohort.train_arena.shape[0])
        self.order_rng.shuffle(order)
        return order

    def setup(self) -> None:
        self.cohort = traffic.make(self.spec["traffic"], self.seed,
                                   self.device)
        self.build()
        gen = torch.Generator(device=self.device).manual_seed(
            derived_seed(self.seed, WEIGHTS_SEED))
        self.weights = self.reference.init(self.model_cfg, gen, self.device)
        self.state.model.load_state_dict(self.weights, strict=True)
        self.train_pre = self.probe.wrap(self.train_pre)
        record, log_probs = self.audit(capture=True)
        self._verify(record, log_probs)

    def _verify(self, record: dict, log_probs: torch.Tensor) -> None:
        order, b = self.next_order(), self.batch
        if len(order) < VERIFY_STEPS * b:
            raise ValueError(f"{len(order)} train rows hold fewer than "
                             f"{VERIFY_STEPS} batches of {b}")
        self.verify_rows = [order[i * b:(i + 1) * b]
                            for i in range(VERIFY_STEPS)]
        state = self.state
        state.generator.manual_seed(derived_seed(self.seed, DRAWS_SEED))
        opt = state.optimizer
        names = {id(p): n for n, p in state.model.named_parameters()}
        self.probe.arm()
        first = self.train_calls(self.verify_rows[0])
        grads = {names[id(p)]: norm(mu / (1.0 - opt.b1))
                 for p, mu in zip(opt.params, opt.state()["mu"])}
        rest = self.train_calls(np.concatenate(self.verify_rows[1:]))
        losses = []
        for m in first + rest:
            live = m["count"].cpu().numpy() > 0
            losses += m["loss"].cpu().numpy()[live].tolist()
        now = state.model.state_dict()
        stat = getattr(self.reference, "is_statistic", lambda n: False)
        self.program = Readings(
            losses=losses, grad_norms=grads,
            delta_norms={n: norm(now[n] - w) for n, w in self.weights.items()
                         if not stat(n)},
            stat_norms={n: norm(now[n] - w) for n, w in self.weights.items()
                        if stat(n)},
            inputs=self.probe.kept, log_probs=log_probs, record=record)

    def epoch(self) -> Epoch:
        """One epoch as the program's loop runs it, under the spans
        ``shuffle``, ``train``, ``fetch`` and ``audit``."""
        with self.spans("shuffle"):
            order = self.next_order()
        with self.spans("train"):
            metrics = self.train_calls(order)
        with self.spans("fetch"):
            done = self.fetch(metrics)
        with self.spans("audit"):
            self.audit()
        return done

    def release(self) -> None:
        """Free the program's state (the cohort and weights stay)."""
        self.state = self.train_pre = self.eval_pre = None
        self.probe.kept = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
