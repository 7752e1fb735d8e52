import sys

from heatx_torch.cli import main

sys.exit(main())
