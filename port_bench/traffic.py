"""The one generator of the benchmark's data: a traffic file
(``port_bench/traffic/<name>.json``) and a seed -> the arenas, labels and
group codes both the program and the reference get.

A traffic file gives the cohort: ``rows``, the ``split`` share that
trains (the first rows of the shuffled cohort, as the reference splits
70/30), the ``frame`` side and ``channels`` of the decoded planar uint8
frames, the ``batch_size`` of its training job, the class ``counts`` of
its labels and, optionally, the ``groups`` the audit reads, each as
``codes`` with their ``counts`` over the cohort (-1 = missing). Every
seed gets the same counts, in another order. The frames are synthetic
and made on the device: a smooth random colour field (a ``field`` x
``field`` grid upsampled) plus uniform pixel noise of half-range
``noise``, so that rows differ the way photographs do at low frequency.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F


class Cohort(NamedTuple):
    train_arena: torch.Tensor         # [N_train, C, S, S] uint8
    test_arena: torch.Tensor          # [N_test, C, S, S] uint8
    train_labels: np.ndarray          # [N_train] int64
    test_labels: np.ndarray           # [N_test] int64
    test_groups: dict                 # attribute -> [N_test] int32 codes


def _shuffled(codes, counts, rng: np.random.Generator) -> np.ndarray:
    out = np.repeat(np.asarray(codes, np.int64), np.asarray(counts))
    rng.shuffle(out)
    return out


def _frames(n: int, spec: dict, generator: torch.Generator,
            chunk: int = 1024) -> torch.Tensor:
    dev = generator.device
    c, s, f = spec["channels"], spec["frame"], spec["image"]["field"]
    half = float(spec["image"]["noise"])
    out = torch.empty((n, c, s, s), dtype=torch.uint8, device=dev)
    for lo in range(0, n, chunk):
        m = min(chunk, n - lo)
        low = torch.rand((m, c, f, f), generator=generator, device=dev)
        x = F.interpolate(low * 255.0, size=(s, s), mode="bilinear",
                          align_corners=False)
        x += (torch.rand((m, c, s, s), generator=generator, device=dev)
              - 0.5) * (2.0 * half)
        out[lo:lo + m] = x.clamp_(0.0, 255.0).to(torch.uint8)
    return out


def make(spec: dict, seed: int, device) -> Cohort:
    """The cohort of traffic ``spec`` under ``seed``, its arenas on
    ``device``."""
    rng = np.random.default_rng(seed)
    labels = _shuffled(range(len(spec["counts"])), spec["counts"], rng)
    n = len(labels)
    if n != spec["rows"]:
        raise ValueError(f"class counts sum to {n}, not rows={spec['rows']}")
    groups = {}
    for attr, g in spec.get("groups", {}).items():
        codes = _shuffled(g["codes"], g["counts"], rng)
        if len(codes) != n:
            raise ValueError(f"group {attr} counts sum to {len(codes)}")
        groups[attr] = codes.astype(np.int32)
    n_train = int(spec["split"] * n)
    gen = torch.Generator(device=device).manual_seed(seed)
    return Cohort(
        train_arena=_frames(n_train, spec, gen),
        test_arena=_frames(n - n_train, spec, gen),
        train_labels=labels[:n_train],
        test_labels=labels[n_train:],
        test_groups={a: c[n_train:] for a, c in groups.items()},
    )
