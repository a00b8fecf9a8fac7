"""Checkpoints in the reference's file contract (port of
``sisr_tpu/train/checkpoint.py``).

The reference keeps ``new_epoch_model.pth`` and its best-metric copies
(experiments/experiment.py:69-73, 256-263, 517-537), each
``torch.save({'start_epoch', 'model': state_dict, 'optimizer':
optimizer.state_dict()})``; the scheduler is rebuilt from start_epoch on
resume.  The port's parameter names are the reference's, so a reference
``.pth`` and the port's own files load alike, strictly.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
from torch import nn


def save_checkpoint(path: str, start_epoch: int, model: nn.Module,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> None:
    """Write atomically (a temporary file, then a rename)."""
    payload = {"start_epoch": int(start_epoch), "model": model.state_dict(),
               "optimizer": optimizer.state_dict() if optimizer is not None else {}}
    tmp = path + ".tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)


def _restore(dic: Dict, model, optimizer) -> Dict:
    if model is not None:
        model.load_state_dict(dic["model"], strict=True)
    if optimizer is not None and dic.get("optimizer"):
        optimizer.load_state_dict(dic["optimizer"])
    return {"start_epoch": int(dic.get("start_epoch", 0)), "model": dic["model"],
            "optimizer": dic.get("optimizer") or None}


def load_checkpoint(path: str, model: Optional[nn.Module] = None,
                    optimizer: Optional[torch.optim.Optimizer] = None) -> Dict:
    """Read ``{'start_epoch', 'model', 'optimizer'}``; load the model
    strictly and the optimizer state (when the file has one) into the
    objects given.  Returns the file's dict, start_epoch as an int."""
    return _restore(torch.load(path, map_location="cpu", weights_only=True), model, optimizer)


def load_any(path: str, model: Optional[nn.Module] = None,
             optimizer: Optional[torch.optim.Optimizer] = None) -> Dict:
    """``load_checkpoint``, and also a bare state dict saved on its own."""
    dic = torch.load(path, map_location="cpu", weights_only=True)
    return _restore(dic if "model" in dic else {"model": dic}, model, optimizer)
