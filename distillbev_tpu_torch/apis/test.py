"""Evaluation loop: loader -> forward + decode -> per-token results.

Counterpart of ``distillbev_tpu/apis/test.py:run_eval`` for the camera
family (``infer_img``): the student's forward and ``get_bboxes`` per
batch, results gathered by sample token.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models.detectors.bevdet import ImgInputs


def _inputs_to_device(img_inputs, device) -> ImgInputs:
    return ImgInputs(*[None if a is None else torch.as_tensor(
        a, device=device) for a in img_inputs])


def run_eval(model, loader, family: str = "img",
             device: str = "cuda") -> Dict[str, Any]:
    """Run inference over ``loader``; return ``{token: (boxes, scores,
    labels, valid)}`` numpy results.

    Each loader item is a dict with ``img_inputs`` (an ``ImgInputs`` or
    the tuple of its arrays) and ``img_metas`` (one dict per sample, the
    token under ``sample_idx``).  Only the camera family is ported.
    """
    if family != "img":
        raise ValueError(f"family {family!r} is not ported; only 'img'")
    model.eval()
    results = {}
    with torch.inference_mode():
        for raw in loader:
            inputs = _inputs_to_device(raw["img_inputs"], device)
            preds, _, _ = model(inputs)
            dec = model.get_bboxes(preds)
            boxes, scores, labels, valid = (
                t.cpu().numpy() for t in dec)
            for bi, meta in enumerate(raw["img_metas"]):
                results[meta.get("sample_idx")] = (
                    boxes[bi], scores[bi], labels[bi], valid[bi])
    return results
