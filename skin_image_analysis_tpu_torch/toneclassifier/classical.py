"""Classical modal-ITA tone classifiers (port of the JAX package's
``toneclassifier.classical``).

One modal-ITA feature per image fed to simple classifiers, as the
reference's colour-map classifier does (LinearSVC there): a 1-D threshold
search, a logistic regression and LinearSVC's objective, the last two fit
by plain gradient descent with ``torch.autograd`` on the CPU in float32,
with the JAX package's step counts, rates, start points and
standardisation.
"""

from __future__ import annotations

import numpy as np
import torch


def _descend(loss, start: list[float], steps: int,
             lr: float) -> torch.Tensor:
    """``steps`` plain gradient steps of ``lr`` on a float32 [w, b]."""
    wb = torch.tensor(start, dtype=torch.float32)
    for _ in range(steps):
        wb.requires_grad_(True)
        (grad,) = torch.autograd.grad(loss(wb), wb)
        wb = (wb - lr * grad).detach()
    return wb


class ModalItaClassifier:
    """Binary tone from modal ITA: light (0) if ita >= threshold.

    ``mode='threshold'``: the exhaustive best-accuracy threshold (a
    decision stump). ``mode='logistic'``: a gradient-fit logistic
    regression. ``mode='svm'``: LinearSVC's default objective (hinge loss
    + L2 penalty, C=1.0) on the standardized feature, gradient-fit.
    """

    def __init__(self, mode: str = "threshold"):
        if mode not in ("threshold", "logistic", "svm"):
            raise ValueError(mode)
        self.mode = mode
        self.threshold_: float | None = None
        self.coef_: tuple[float, float] | None = None

    def fit(self, modal_ita: np.ndarray,
            tone: np.ndarray) -> "ModalItaClassifier":
        """tone: 0=light, 1=dark. NaN features are dropped for fitting."""
        x = np.asarray(modal_ita, np.float64)
        y = np.asarray(tone, np.int32)
        ok = ~np.isnan(x)
        x, y = x[ok], y[ok]
        if self.mode == "threshold":
            best_acc, best_t = -1.0, 0.0
            for t in np.unique(x):
                acc = float(np.mean((x < t).astype(np.int32) == y))
                if acc > best_acc:
                    best_acc, best_t = acc, float(t)
            self.threshold_ = best_t
        elif self.mode == "svm":
            # mean hinge loss + (1/(2*C*n))*||w||^2, labels in {-1, +1}
            # (+1 = dark = low ITA, so the margin is on -x)
            mu, sd = float(x.mean()), float(x.std() or 1.0)
            yt = torch.tensor(2 * y - 1, dtype=torch.float32)
            xt = torch.tensor(-(x - mu) / sd, dtype=torch.float32)
            n = float(len(x))

            def loss(wb):
                w, b = wb[0], wb[1]
                hinge = torch.maximum(torch.zeros(()),
                                      1.0 - yt * (w * xt + b)).mean()
                return hinge + (w * w) / (2.0 * n)

            w, b = (float(v) for v in _descend(loss, [1.0, 0.0], 2000, 0.05))
            # predict()'s convention is dark <=> w_raw*x + b_raw <= 0; dark
            # was trained as w*(-(x-mu)/sd) + b >= 0
            self.coef_ = (w / sd, -w * mu / sd - b)
        else:
            xt = torch.tensor(x, dtype=torch.float32)
            yt = torch.tensor(y, dtype=torch.float32)

            def loss(wb):
                p = torch.sigmoid(-(wb[0] * xt + wb[1]))  # dark as ITA falls
                eps = 1e-7
                return -(yt * torch.log(p + eps)
                         + (1 - yt) * torch.log(1 - p + eps)).mean()

            w, b = (float(v) for v in _descend(loss, [0.0, 0.0], 500, 0.1))
            self.coef_ = (w, b)
        return self

    def predict(self, modal_ita: np.ndarray) -> np.ndarray:
        """NaN features predict the dark class 1."""
        x = np.asarray(modal_ita, np.float64)
        if self.mode == "threshold":
            if self.threshold_ is None:
                raise RuntimeError("fit first")
            out = (x < self.threshold_).astype(np.int32)
        else:
            if self.coef_ is None:
                raise RuntimeError("fit first")
            w, b = self.coef_
            out = (1.0 / (1.0 + np.exp(w * x + b)) >= 0.5).astype(np.int32)
        return np.where(np.isnan(x), 1, out)

    def score(self, modal_ita: np.ndarray, tone: np.ndarray) -> float:
        return float(np.mean(self.predict(modal_ita) == np.asarray(tone)))
