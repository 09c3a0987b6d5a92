"""``python -m bluefog_tpu_torch.tools``: the host tools' command line."""

import sys

from bluefog_tpu_torch.tools import main

if __name__ == "__main__":
    sys.exit(main())
