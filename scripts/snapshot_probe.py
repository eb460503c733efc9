"""Run `chip_smoke.py`'s `snapshot_train` with only the phases it stands
on, on one card: the three kernel phases (they build the kernels that
`import_export`'s build-directory check lists), the recommended-user
template (`recuser_*`), `import_export`, `nativelog_train`, then
`snapshot_train`. About 3 minutes, against the whole smoke's 15; the
phase lines are the smoke's.

    python3 scripts/snapshot_probe.py > chiprun_out/snap_probe.log
"""

import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="snap_probe_") as workdir:
        cs.use_store(workdir)
        try:
            info = cs.phase_device()
            cs.phase_kernel()
            cs.phase_chol_kernel()
            cs.phase_schulz_kernel()
            _, recuser = cs.phase_recuser(workdir)
            path, n = cs.phase_import_export(workdir)
            cs.phase_nativelog_train(workdir, path, n, recuser)
            cs.phase_snapshot_train(workdir, recuser)
        finally:
            from predictionio_tpu_torch.data.storage import registry
            registry.clear_cache()
    print(f"probe done in {time.perf_counter() - t0:.1f} s", flush=True)
    print(info["nvidia_smi"], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
