"""Training entry point of the PyTorch port.

Usage:
  python -m semi_supervised_semantic_segmentation_tpu_torch.train \\
      --config configs/3_fixmatch_dlv3p_r50_voc_512.yaml \\
      --set data.dataset=synthetic data.cutmix_impl=pallas model.stem_impl=pallas
  ... --device cpu   (explicit CPU run; the default is CUDA, which must exist)
  ... --resume auto  (the latest slot of <work_dir>/checkpoints; or DIR, DIR:STEP)
"""

from __future__ import annotations

import argparse
import json
import logging

from semi_supervised_semantic_segmentation_tpu_torch.config import load_config, parse_overrides
from semi_supervised_semantic_segmentation_tpu_torch.engine.trainer import Trainer


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", required=True, help="YAML config path")
    p.add_argument("--set", nargs="*", default=[], metavar="KEY=VALUE",
                   help="dotted config overrides, e.g. optim.lr=0.02")
    p.add_argument("--work_dir", default=None)
    p.add_argument("--device", default=None, help="cuda (default) | cpu | cuda:N")
    p.add_argument("--resume", default=None, metavar="auto|DIR|DIR:STEP",
                   help="resume from a checkpoint slot ('auto': the latest in work_dir)")
    p.add_argument("--init_from_torch", default=None, metavar="CKPT.pth",
                   help="initialize from a reference-layout torch checkpoint")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(levelname)s %(message)s")
    try:
        overrides = parse_overrides(args.set)
    except ValueError as e:
        raise SystemExit(str(e))
    if args.work_dir is not None:
        overrides["train.work_dir"] = args.work_dir
    if args.resume is not None:
        overrides["train.resume"] = args.resume
    if args.init_from_torch is not None:
        overrides["train.init_from_torch"] = args.init_from_torch
    cfg = load_config(args.config, overrides)
    trainer = Trainer(cfg, device=args.device)
    best = trainer.fit()
    print(f"best mIoU: {best:.4f}")
    print(json.dumps({**trainer.last, "best_miou": best}))


if __name__ == "__main__":
    main()
