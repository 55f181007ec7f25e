"""The error hierarchy of the port (copy of `cabinet_tpu.core.exceptions`)."""


class CABiNetError(Exception):
    """Base class for all framework errors."""


class ModelLoadError(CABiNetError):
    """Raised when model weights cannot be loaded or converted."""


class DatasetError(CABiNetError):
    """Raised for dataset discovery / integrity problems."""


class ConfigurationError(CABiNetError):
    """Raised for invalid or inconsistent configuration."""


class TrainingError(CABiNetError):
    """Raised for unrecoverable training-loop failures."""
