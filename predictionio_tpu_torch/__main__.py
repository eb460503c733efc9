"""`python -m predictionio_tpu_torch {version,train,deploy,undeploy}`
(`tools/cli.py`)."""

import sys

from predictionio_tpu_torch.tools.cli import main

if __name__ == "__main__":
    sys.exit(main())
