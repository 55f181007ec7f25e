"""Dataset conversion CLIs (counterpart of `cabinet_tpu.cli.convert`; the
reference's convert_{uavid,aeroscapes,vdd}_to_yolo.py). Runs on the host:
PNG needs neither PIL nor a device, and JPEG is only copied or linked.

Usage:
    python -m cabinet_tpu_torch.cli.convert uavid --src ... --dst ... [--info X.json]
        [--workers N] [--copy-images] [--dry-run]
    python -m cabinet_tpu_torch.cli.convert aeroscapes --src ... --dst ... [--dry-run]
    python -m cabinet_tpu_torch.cli.convert vdd --src ... --dst ... [--dry-run]
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Optional, Sequence

from cabinet_tpu_torch.data import converters
from cabinet_tpu_torch.data.palettes import PALETTES, load_labels_info


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="dataset", required=True)

    pu = sub.add_parser("uavid", help="RGB Labels/ -> class-ID masks")
    pu.add_argument("--src", required=True, type=Path)
    pu.add_argument("--dst", required=True, type=Path)
    pu.add_argument("--info", type=Path, default=None,
                    help="UAVid_info.json (default: built-in palette)")
    pu.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    pu.add_argument("--copy-images", action="store_true")
    pu.add_argument("--dry-run", action="store_true")

    pa = sub.add_parser("aeroscapes", help="ImageSets split -> copied pairs")
    pa.add_argument("--src", required=True, type=Path)
    pa.add_argument("--dst", required=True, type=Path)
    pa.add_argument("--workers", type=int, default=os.cpu_count() or 1)
    pa.add_argument("--dry-run", action="store_true")

    pv = sub.add_parser("vdd", help="src/gt pairs -> symlinked pairs")
    pv.add_argument("--src", required=True, type=Path)
    pv.add_argument("--dst", required=True, type=Path)
    pv.add_argument("--dry-run", action="store_true")

    args = p.parse_args(argv)
    if not args.src.exists():
        raise FileNotFoundError(f"--src does not exist: {args.src}")

    if args.dataset == "uavid":
        classes = (load_labels_info(args.info) if args.info
                   else PALETTES["uavid"])
        n = converters.convert_uavid(args.src, args.dst, classes,
                                     workers=args.workers,
                                     copy_images=args.copy_images,
                                     dry_run=args.dry_run)
    elif args.dataset == "aeroscapes":
        n = converters.convert_aeroscapes(args.src, args.dst,
                                          workers=args.workers,
                                          dry_run=args.dry_run)
    else:
        n = converters.convert_vdd(args.src, args.dst, dry_run=args.dry_run)

    print(f"[DONE] Total masks {'scanned' if args.dry_run else 'written'}: {n}")
    if not args.dry_run:
        print(f"       Output: {args.dst}")


if __name__ == "__main__":
    main()
