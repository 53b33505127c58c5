"""Xception's epochs: the transfer models' (``transfer_epochs``), with
the Xception reference, and the depthwise convs' bound left for the
metrics that read it (``port_bench.depthwise``)."""

from __future__ import annotations

import torch

from port_bench import depthwise
from port_bench.drivers.transfer_epochs import TransferEpochs
from port_bench.reference import xception


class XceptionEpochs(TransferEpochs):
    reference = xception

    def setup(self) -> None:
        super().setup()
        cfg = self.model_cfg
        elem = torch.finfo(getattr(torch, cfg["compute_dtype"])).bits // 8
        depthwise.left = depthwise.bound(self.reference, cfg, self.batch,
                                         elem)


Driver = XceptionEpochs
