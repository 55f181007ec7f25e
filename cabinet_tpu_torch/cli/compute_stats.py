"""Dataset mean/std computation CLI (counterpart of
`cabinet_tpu.cli.compute_stats`; the reference's compute_*_stats.py). Runs
on the host: PNG needs neither PIL nor a device.

Usage:
    python -m cabinet_tpu_torch.cli.compute_stats /data/uavid/images/train
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

from cabinet_tpu_torch.data.stats import compute_dataset_stats


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("image_dir", help="directory of training images")
    p.add_argument("--max-images", type=int, default=0,
                   help="cap the number of images scanned (0 = all)")
    args = p.parse_args(argv)
    mean, std = compute_dataset_stats(args.image_dir,
                                      max_images=args.max_images)
    print(f"mean: ({mean[0]:.3f}, {mean[1]:.3f}, {mean[2]:.3f})")
    print(f"std:  ({std[0]:.3f}, {std[1]:.3f}, {std[2]:.3f})")


if __name__ == "__main__":
    main()
