"""Offline data preparation CLI: the info pkls and the GT database.

Counterpart of the JAX package's ``tools/create_data.py`` (reference:
tools/create_data.py)::

    python -m bevfusion_tpu_torch.tools.create_data nuscenes --root data/nuscenes \\
        [--version v1.0-trainval] [--max-sweeps 10] [--skip-gt-database] [--skip-infos]

writes ``nuscenes_infos_{train,val}.pkl`` (this needs the nuScenes devkit)
and then, from the train infos, ``nuscenes_gt_database/`` with
``nuscenes_dbinfos_train.pkl``, which ``ObjectPaste`` samples from.
``--skip-infos`` builds only the GT database from infos already on disk
(those of ``data/synthetic.py``, say), which needs numpy alone.
"""
from __future__ import annotations

import argparse
import os
from typing import List, Optional

from ..data.converter import create_gt_database, create_nuscenes_infos

CLASSES = ["car", "truck", "construction_vehicle", "bus", "trailer", "barrier", "motorcycle",
           "bicycle", "pedestrian", "traffic_cone"]


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dataset", choices=["nuscenes"])
    ap.add_argument("--root", default="data/nuscenes")
    ap.add_argument("--version", default="v1.0-trainval")
    ap.add_argument("--max-sweeps", type=int, default=10)
    ap.add_argument("--skip-gt-database", action="store_true")
    ap.add_argument("--skip-infos", action="store_true",
                    help="build the GT database from the train infos already under --root")
    args = ap.parse_args(argv)

    if not args.skip_infos:
        n_train, n_val = create_nuscenes_infos(args.root, version=args.version,
                                               max_sweeps=args.max_sweeps)
        print(f"infos: {n_train} train / {n_val} val")
    if not args.skip_gt_database and "test" not in args.version:
        create_gt_database(args.root, os.path.join(args.root, "nuscenes_infos_train.pkl"),
                           CLASSES)


if __name__ == "__main__":
    main()
