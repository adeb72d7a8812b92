"""Evaluation entry point of the PyTorch port.

Usage:
  python -m semi_supervised_semantic_segmentation_tpu_torch.eval \\
      --config configs/3_fixmatch_dlv3p_r50_voc_512.yaml --checkpoint X.pth \\
      --set data.dataset=synthetic model.stem_impl=pallas
  ... --save_preds DIR        palette PNG predictions of every val image
  ... --export_torch OUT.pth  write the loaded state back as a reference-layout file
  ... --device cpu            (explicit CPU run; the default is CUDA, which must exist)

``--checkpoint`` reads a reference-layout ``torch.save`` file (.pth / .pt),
as the JAX package's ``eval.py --export_torch`` writes it, or a directory
of the port's checkpoint manager (``<work_dir>/checkpoints``, its latest
slot) or ``dir:step``.  An Orbax directory of the JAX package crosses over
as a file written by its ``eval.py --export_torch``.
"""

from __future__ import annotations

import argparse
import os

from semi_supervised_semantic_segmentation_tpu_torch import resolve_device
from semi_supervised_semantic_segmentation_tpu_torch.config import (
    Config,
    load_config,
    parse_overrides,
)
from semi_supervised_semantic_segmentation_tpu_torch.engine import compat
from semi_supervised_semantic_segmentation_tpu_torch.engine.checkpoint import (
    CheckpointManager,
    parse_checkpoint_arg,
)
from semi_supervised_semantic_segmentation_tpu_torch.engine.evaluator import (
    inference_model,
    make_evaluator,
    make_predict_step,
    run_eval,
    save_predictions,
    val_loader,
)
from semi_supervised_semantic_segmentation_tpu_torch.methods import common, get_method
from semi_supervised_semantic_segmentation_tpu_torch.models import build_model
from semi_supervised_semantic_segmentation_tpu_torch.ops.metrics import (
    class_names,
    format_iou_table,
)


def load_state(cfg: Config, checkpoint: str, device):
    """A fresh train state of ``cfg`` on ``device`` (CPS: both nets) with
    the checkpoint loaded into it -> (state, method module, meta).  ``checkpoint``: a
    reference-layout file, or a checkpoint directory (its latest slot) or
    ``dir:step``."""
    method = get_method(cfg.method.name)
    model = build_model(cfg).to(device)
    state = method.init_state(cfg, model, max(cfg.train.epochs, 1))
    if checkpoint.endswith((".pth", ".pt")):
        if not os.path.isfile(checkpoint):
            raise FileNotFoundError(checkpoint)
        return state, method, compat.import_reference_checkpoint(checkpoint, state)
    directory, step = parse_checkpoint_arg(checkpoint)
    if not os.path.isdir(directory):
        raise FileNotFoundError(directory)
    return state, method, CheckpointManager(directory).restore(state, step)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True)
    p.add_argument("--checkpoint", required=True,
                   help="reference-layout checkpoint (.pth), or a checkpoint directory or dir:step")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE")
    p.add_argument("--device", default=None, help="cuda (default) | cpu | cuda:N")
    p.add_argument("--save_preds", default=None, metavar="DIR",
                   help="write palette PNG predictions for every val image")
    p.add_argument("--export_torch", default=None, metavar="OUT.pth",
                   help="export the loaded state as a reference-layout torch checkpoint")
    args = p.parse_args(argv)
    try:
        overrides = parse_overrides(args.set)
    except ValueError as e:
        raise SystemExit(str(e))
    cfg = load_config(args.config, overrides)
    device = resolve_device(args.device)
    state, method, meta = load_state(cfg, args.checkpoint, device)
    if args.export_torch:
        compat.export_reference_checkpoint(args.export_torch, state, meta, cfg)
        print(f"reference-layout checkpoint written to {args.export_torch}")

    val = val_loader(cfg)
    model = inference_model(state, method)
    try:
        if args.save_preds:
            predict = make_predict_step(cfg)
            model.eval()
            for batch in val.epoch(0):
                preds = predict(model, common.to_device(batch, device))
                save_predictions(preds, batch, val.dataset, args.save_preds)
            print(f"predictions written to {args.save_preds}")
        iou, miou, acc = run_eval(make_evaluator(cfg), model, val, device)
    finally:
        val.close()
    print(format_iou_table(iou, class_names(cfg.data.dataset, cfg.data.num_classes)))
    print(f"mIoU: {miou:.4f}  pixel-acc: {acc:.4f}")
    return iou, miou, acc


if __name__ == "__main__":
    main()
