"""``python -m webradio`` — run the SDR server (the main.cxx analog)."""

import sys

from .app import main

if __name__ == "__main__":
    sys.exit(main())
