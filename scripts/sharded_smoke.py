"""The smoke's sharded phases alone on the card: `chip_smoke.py`'s
kernel build, store train, sharded phases and store deploy, on a
temporary store.

    python3 scripts/sharded_smoke.py

Prints the phases' JSON lines (`store_train`, `sharded_*`,
`store_deploy` with its warm's `warm_allocated`, `cli_train`,
`store_reload`) and the card's name and power limit; about 4 minutes,
most of it the store's 2M-event import.
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke as S  # noqa: E402


def main() -> int:
    with tempfile.TemporaryDirectory(prefix="pio_smoke_store_") as wd:
        S.use_store(wd)
        info = S.phase_device()
        path, iid, trained, launches, _ = S.phase_store_train(wd)
        S.phase_sharded(wd, trained, launches)
        with S.exact_pack():
            S.phase_store_deploy(path, iid, trained)
    print(info["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
