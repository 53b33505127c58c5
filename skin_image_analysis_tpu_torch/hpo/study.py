"""Ask/tell hyper-parameter search engine (a copy of the JAX package's
``hpo.study``).

The reference drives a 100-trial Optuna sweep with a median pruner,
launched as independent MPI processes on a supercomputer
(tone_bias_optuna.py:291-343, README.md:54; optuna itself is not available
in this environment). This module is a from-scratch engine exposing the
same concepts — ``suggest_int/float/categorical``, per-epoch
``trial.report`` + ``trial.should_prune`` (the protocol used at
tone_bias_optuna.py:282-286), pruned/complete bookkeeping, best-trial
selection — with an explicit ask/tell API so trial *populations* can run
in parallel as stacked waves (see hpo.wave) instead of as MPI ranks.

``TrialReplay`` mirrors the reference's ``TrialDummy`` (:47-76): a
dict-backed stand-in that replays a winning parameter set through any
``define_*`` search-space function.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Sequence

import numpy as np


class TrialPruned(Exception):
    """Raised inside an objective to stop a hopeless trial."""


class TrialState:
    RUNNING = "RUNNING"
    COMPLETE = "COMPLETE"
    PRUNED = "PRUNED"
    FAILED = "FAILED"


class RandomSampler:
    """Independent uniform / log-uniform / choice sampling."""

    def __init__(self, seed: int | None = None):
        self.rng = np.random.default_rng(seed)

    def sample_int(self, low: int, high: int, log: bool = False) -> int:
        if log:
            return int(
                round(
                    math.exp(
                        self.rng.uniform(math.log(low), math.log(high))
                    )
                )
            )
        return int(self.rng.integers(low, high + 1))

    def sample_float(self, low: float, high: float, log: bool = False) -> float:
        if log:
            return float(np.exp(self.rng.uniform(np.log(low), np.log(high))))
        return float(self.rng.uniform(low, high))

    def sample_categorical(self, choices: Sequence[Any]) -> Any:
        return choices[int(self.rng.integers(0, len(choices)))]


class MedianPruner:
    """Prune when the reported value is below the median of prior trials'
    values at the same step (optuna's default pruner, the one the
    reference relies on)."""

    def __init__(self, n_startup_trials: int = 5, n_warmup_steps: int = 0):
        self.n_startup_trials = n_startup_trials
        self.n_warmup_steps = n_warmup_steps

    def should_prune(self, study: "Study", trial: "Trial") -> bool:
        if not trial.intermediate_values:
            return False
        step = max(trial.intermediate_values)
        if step < self.n_warmup_steps:
            return False
        finished = [
            t for t in study.trials
            if t.state in (TrialState.COMPLETE, TrialState.PRUNED)
            and t.number != trial.number
        ]
        if len(finished) < self.n_startup_trials:
            return False
        peers = [
            t.intermediate_values[step]
            for t in finished
            if step in t.intermediate_values
        ]
        if not peers:
            return False
        median = float(np.median(peers))
        value = trial.intermediate_values[step]
        return (value < median) if study.direction == "maximize" else (value > median)


class Trial:
    def __init__(self, study: "Study", number: int, sampler: RandomSampler):
        self.study = study
        self.number = number
        self._sampler = sampler
        self.params: dict[str, Any] = {}
        self.intermediate_values: dict[int, float] = {}
        self.value: float | None = None
        self.state = TrialState.RUNNING

    def suggest_int(self, name: str, low: int, high: int, log: bool = False) -> int:
        if hasattr(self._sampler, "sample_int_ctx"):
            value = self._sampler.sample_int_ctx(self.study, name, low, high, log)
        else:
            value = self._sampler.sample_int(low, high, log)
        self.params[name] = value
        return value

    def suggest_float(
        self, name: str, low: float, high: float, log: bool = False
    ) -> float:
        if hasattr(self._sampler, "sample_float_ctx"):
            value = self._sampler.sample_float_ctx(self.study, name, low, high, log)
        else:
            value = self._sampler.sample_float(low, high, log)
        self.params[name] = value
        return value

    def suggest_categorical(self, name: str, choices: Sequence[Any]) -> Any:
        if hasattr(self._sampler, "sample_categorical_ctx"):
            value = self._sampler.sample_categorical_ctx(self.study, name, choices)
        else:
            value = self._sampler.sample_categorical(choices)
        self.params[name] = value
        return value

    def report(self, value: float, step: int) -> None:
        self.intermediate_values[int(step)] = float(value)

    def should_prune(self) -> bool:
        return self.study.pruner.should_prune(self.study, self)


class TrialReplay:
    """Replays a fixed parameter dict through suggest_* calls
    (reference TrialDummy, tone_bias_optuna.py:47-76)."""

    def __init__(self, params: dict[str, Any]):
        self.params = dict(params)
        self.intermediate_values: dict[int, float] = {}
        self.number = -1

    def _get(self, name: str):
        if name not in self.params:
            raise KeyError(f"replay missing parameter {name!r}")
        return self.params[name]

    def suggest_int(self, name: str, low: int, high: int, log: bool = False) -> int:
        return int(self._get(name))

    def suggest_float(self, name: str, low: float, high: float, log: bool = False) -> float:
        return float(self._get(name))

    def suggest_categorical(self, name: str, choices: Sequence[Any]) -> Any:
        return self._get(name)

    def report(self, value: float, step: int) -> None:
        self.intermediate_values[int(step)] = float(value)

    def should_prune(self) -> bool:
        return False


class Study:
    """Maximize/minimize study with ask/tell + optimize loops."""

    def __init__(
        self,
        direction: str = "maximize",
        sampler: RandomSampler | None = None,
        pruner: MedianPruner | None = None,
    ):
        if direction not in ("maximize", "minimize"):
            raise ValueError(direction)
        self.direction = direction
        self.sampler = sampler or RandomSampler()
        self.pruner = pruner or MedianPruner()
        self.trials: list[Trial] = []

    # -- ask/tell ---------------------------------------------------------
    def ask(self) -> Trial:
        trial = Trial(self, len(self.trials), self.sampler)
        self.trials.append(trial)
        return trial

    def tell(
        self, trial: Trial, value: float | None, state: str = TrialState.COMPLETE
    ) -> None:
        trial.value = None if value is None else float(value)
        trial.state = state

    # -- driver loop ------------------------------------------------------
    def optimize(
        self,
        objective: Callable[[Trial], float],
        n_trials: int = 100,
        timeout: float | None = None,
        callbacks: Sequence[Callable[["Study", Trial], None]] = (),
    ) -> None:
        start = time.time()
        for _ in range(n_trials):
            if timeout is not None and time.time() - start > timeout:
                break
            trial = self.ask()
            try:
                value = objective(trial)
                self.tell(trial, value, TrialState.COMPLETE)
            except TrialPruned:
                last = (
                    trial.intermediate_values[max(trial.intermediate_values)]
                    if trial.intermediate_values
                    else None
                )
                self.tell(trial, last, TrialState.PRUNED)
            except Exception:
                self.tell(trial, None, TrialState.FAILED)
                raise
            for cb in callbacks:
                cb(self, trial)

    # -- results ----------------------------------------------------------
    @property
    def completed_trials(self) -> list[Trial]:
        return [t for t in self.trials if t.state == TrialState.COMPLETE]

    @property
    def pruned_trials(self) -> list[Trial]:
        return [t for t in self.trials if t.state == TrialState.PRUNED]

    @property
    def best_trial(self) -> Trial:
        done = self.completed_trials
        if not done:
            raise ValueError("no completed trials")
        key = (lambda t: t.value) if self.direction == "maximize" else (
            lambda t: -t.value
        )
        return max(done, key=key)

    @property
    def best_params(self) -> dict[str, Any]:
        return dict(self.best_trial.params)

    @property
    def best_value(self) -> float:
        return self.best_trial.value


def create_study(
    direction: str = "maximize",
    sampler: RandomSampler | None = None,
    pruner: MedianPruner | None = None,
) -> Study:
    return Study(direction, sampler, pruner)
