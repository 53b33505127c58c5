"""Tree-structured Parzen Estimator sampler (a copy of the JAX package's
``hpo.tpe``).

Optuna's default sampler (the engine behind the reference's 100-trial
sweep) is TPE; this is a from-scratch implementation on the same
ask/tell engine. Per parameter: completed trials split into the best
γ-quantile ("good", l) and the rest ("bad", g); Parzen (Gaussian-KDE)
densities model each; candidates drawn from l are scored by l(x)/g(x)
and the best candidate wins (Bergstra et al., 2011). Falls back to
uniform sampling until ``n_startup_trials`` trials complete, and per
parameter name to uniform when history is thin — which also handles the
conditional parameters of the ISIC search space (conv_out_i exists only
for trials with enough layers).
"""

from __future__ import annotations

import math
from typing import Any, Sequence

import numpy as np

from skin_image_analysis_tpu_torch.hpo.study import RandomSampler, TrialState


class TPESampler(RandomSampler):
    def __init__(
        self,
        seed: int | None = None,
        n_startup_trials: int = 10,
        gamma: float = 0.25,
        n_candidates: int = 24,
    ):
        super().__init__(seed)
        self.n_startup_trials = n_startup_trials
        self.gamma = gamma
        self.n_candidates = n_candidates

    # -- history helpers --------------------------------------------------
    def _observations(self, study, name: str) -> tuple[np.ndarray, np.ndarray]:
        """Completed AND pruned trials feed the densities — pruned
        trials carry their last intermediate value (Study.optimize /
        the wave engine record it at tell time). Dropping them starves
        the history under a median pruner (~60% of trials die early)
        and discards exactly the strongest 'bad' signal: measured in
        tpe_regret_100_20_pruned.json, COMPLETE-only TPE fell to
        parity with random search (8/20 seed wins) while this form
        separates — the same design choice Optuna's TPE makes."""
        values, scores = [], []
        for t in study.trials:
            if t.state not in (TrialState.COMPLETE, TrialState.PRUNED):
                continue
            if t.value is None:
                continue
            if name in t.params:
                values.append(t.params[name])
                scores.append(t.value)
        return np.asarray(values, dtype=object), np.asarray(scores, float)

    def _split(self, values: np.ndarray, scores: np.ndarray, maximize: bool):
        n_good = max(1, int(math.ceil(self.gamma * len(values))))
        order = np.argsort(scores)
        if maximize:
            order = order[::-1]
        good = values[order[:n_good]]
        bad = values[order[n_good:]]
        return good, bad

    # -- Parzen densities --------------------------------------------------
    @staticmethod
    def _kde_logpdf(x: np.ndarray, samples: np.ndarray, lo: float, hi: float):
        samples = samples.astype(float)
        sigma = max((hi - lo) / max(len(samples), 1), 1e-12)
        diffs = (x[:, None] - samples[None, :]) / sigma
        log_kernels = -0.5 * diffs**2 - math.log(sigma * math.sqrt(2 * math.pi))
        m = log_kernels.max(axis=1, keepdims=True)
        return (m[:, 0] + np.log(
            np.exp(log_kernels - m).sum(axis=1) / len(samples)
        ))

    def _sample_numeric(self, study, name, low, high, log, integer):
        values, scores = self._observations(study, name)
        done = len(scores)
        to_domain = (lambda v: math.log(v)) if log else (lambda v: v)
        lo, hi = to_domain(low), to_domain(high)
        if done < self.n_startup_trials or len(values) < 4:
            return None  # caller falls back to uniform
        vals = np.asarray([to_domain(float(v)) for v in values])
        good, bad = self._split(vals, scores, study.direction == "maximize")
        if len(bad) == 0:
            return None
        sigma = max((hi - lo) / max(len(good), 1), 1e-12)
        cand = self.rng.choice(good, size=self.n_candidates) + \
            self.rng.normal(0, sigma, self.n_candidates)
        cand = np.clip(cand, lo, hi)
        score = self._kde_logpdf(cand, good, lo, hi) - self._kde_logpdf(
            cand, bad, lo, hi
        )
        best = float(cand[int(np.argmax(score))])
        value = math.exp(best) if log else best
        if integer:
            return int(round(min(max(value, low), high)))
        return float(min(max(value, low), high))

    # -- context-aware sampling API (used by Trial) ------------------------
    def sample_int_ctx(self, study, name, low, high, log=False) -> int:
        out = self._sample_numeric(study, name, low, high, log, integer=True)
        return out if out is not None else self.sample_int(low, high, log)

    def sample_float_ctx(self, study, name, low, high, log=False) -> float:
        out = self._sample_numeric(study, name, low, high, log, integer=False)
        return out if out is not None else self.sample_float(low, high, log)

    def sample_categorical_ctx(self, study, name, choices: Sequence[Any]) -> Any:
        values, scores = self._observations(study, name)
        if len(scores) < self.n_startup_trials:
            return self.sample_categorical(choices)
        good, bad = self._split(values, scores, study.direction == "maximize")
        prior = 1.0
        weights = []
        for c in choices:
            l_c = (np.sum(good == c) + prior) / (len(good) + prior * len(choices))
            g_c = (np.sum(bad == c) + prior) / (len(bad) + prior * len(choices))
            weights.append(l_c / g_c)
        weights = np.asarray(weights)
        probs = weights / weights.sum()
        return choices[int(self.rng.choice(len(choices), p=probs))]
