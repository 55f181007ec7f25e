"""Model constants read by the CABiNet modules (copy of the part of
`cabinet_tpu.core.constants` that the models use)."""

from typing import Any, Dict

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
