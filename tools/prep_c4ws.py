"""Host-only prebuild of the run_config4 workspace (FASTA + reads + sharded
index artifacts) so the device-facing CLI run starts with zero host build work.

Honors the same env knobs as tools/run_config4.py (NGM_C4_GBP, NGM_C4_DIR,
NGM_C4_MODE, NGM_C4_K, NGM_C4_SHARDS).  Runs entirely on the CPU backend.
"""

import os
import subprocess
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_here = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(_here))
sys.path.insert(0, _here)  # explicit: `python -m tools.prep_c4ws` works too

import run_config4 as c4  # noqa: E402  (same dir)


def main():
    t0 = time.time()
    ref, fq = c4.build_inputs()
    print(f"inputs ready in {time.time() - t0:.0f}s: {ref} {fq}",
          flush=True)
    args = [sys.executable, "-m", "nextgenmap_tpu.cli", "index",
            "-r", ref, "-k", c4.K, "--index-shards", c4.SHARDS]
    if c4.MODE == "bs":
        args += ["--bs-mapping"]
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    env["JAX_PLATFORMS"] = "cpu"
    t1 = time.time()
    r = subprocess.run(args, env=env)
    print(f"index+shards built in {time.time() - t1:.0f}s rc={r.returncode}",
          flush=True)
    return r.returncode


if __name__ == "__main__":
    sys.exit(main())
