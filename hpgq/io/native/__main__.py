"""Build (or find) the native packer ahead of time: ``python -m hpgq.io.native``."""

import sys

from . import get_lib

if get_lib() is None:
    print("native packer unavailable (no g++?); the numpy packer will be used")
    sys.exit(1)
from . import loaded_path

print(loaded_path)
