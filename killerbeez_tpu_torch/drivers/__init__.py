"""Driver layer: delivers candidate inputs to the target
(reference driver/driver.h vtable + factories)."""

from .base import Driver
from .factory import (
    driver_factory, driver_help, driver_names, register_driver,
)
from .file_driver import FileDriver
from .network_client import NetworkClientDriver
from .network_server import NetworkServerDriver
from .stdin_driver import StdinDriver

__all__ = ["Driver", "driver_factory", "driver_help", "driver_names",
           "register_driver", "FileDriver", "StdinDriver",
           "NetworkServerDriver", "NetworkClientDriver"]
