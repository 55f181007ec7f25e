"""Constants read by the CABiNet modules and the evaluator (copy of the part
of `cabinet_tpu.core.constants` that the port uses)."""

from typing import Any, Dict

# Evaluation constants (sliding-window protocol, reference evaluate.py:124-126).
EVAL_STRIDE_RATE = 5 / 6.0
DEFAULT_IGNORE_LABEL = 255

# MobileNetV3 backbone final feature widths (pre-pool 1x1 conv output).
MOBILENET_LARGE_FEATURES = 960
MOBILENET_SMALL_FEATURES = 576

# Channels entering the attention branch per backbone mode.
MODEL_CONFIG: Dict[str, Dict[str, Any]] = {
    "large": {
        "attention_planes": MOBILENET_LARGE_FEATURES,
        "output_channel": 1280,
    },
    "small": {
        "attention_planes": MOBILENET_SMALL_FEATURES,
        "output_channel": 1024,
    },
}

# Training constants.
OHEM_DIVISOR = 16  # n_min = batch * crop_h * crop_w // OHEM_DIVISOR
DEFAULT_SCORE_THRESHOLD = 0.7  # OHEM loss threshold

# Most samples `cli/visualize.py` writes.
VISUALIZATION_SAMPLE_LIMIT = 50
