"""Driver layer: delivers candidate inputs to the target
(reference driver/driver.h vtable + factories)."""

from .base import Driver
from .factory import (
    driver_factory, driver_help, driver_names, register_driver,
)
from .file_driver import FileDriver

__all__ = ["Driver", "driver_factory", "driver_help", "driver_names",
           "register_driver", "FileDriver"]
