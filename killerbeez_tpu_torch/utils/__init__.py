"""Host utilities: leveled logging, JSON option parsing, file IO and
state serialization (copies of the JAX package's ``utils``)."""

from .logging import (
    setup_logging,
    logging_help,
    DEBUG_MSG,
    INFO_MSG,
    WARNING_MSG,
    ERROR_MSG,
    CRITICAL_MSG,
    FATAL_MSG,
    get_logger,
)
from .options import (
    parse_options,
    get_option,
    add_int_option_to_json,
    add_option_to_json,
)
from .fileio import (
    read_file,
    write_buffer_to_file,
    file_exists,
    get_temp_filename,
    md5_hex,
)
from .serialization import encode_mem_array, decode_mem_array

__all__ = [
    "setup_logging", "logging_help", "get_logger",
    "DEBUG_MSG", "INFO_MSG", "WARNING_MSG", "ERROR_MSG", "CRITICAL_MSG",
    "FATAL_MSG",
    "parse_options", "get_option", "add_int_option_to_json",
    "add_option_to_json",
    "read_file", "write_buffer_to_file", "file_exists", "get_temp_filename",
    "md5_hex",
    "encode_mem_array", "decode_mem_array",
]
