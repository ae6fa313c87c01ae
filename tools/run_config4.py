"""BASELINE config-4/5 driver: gigabase genome, sharded index, one chip.

Builds a 1.2 Gbp 4-chromosome genome + simulated reads, then runs the REAL
CLI (`ngm-tpu map --index-shards S`) end-to-end and reports streaming rate +
truth accuracy.  Modes:

  NGM_C4_MODE=plain      - config 4: 2% SNP reads (default)
  NGM_C4_MODE=divergent  - config-5-style: 10% SNPs
  NGM_C4_MODE=bs         - config 5 as specified: --bs-mapping with
                           80%-converted C->T (or G->A on rev) 10%-SNP reads

Artifacts (FASTA, index, shards) are memoized in NGM_C4_DIR (default
/root/c4ws) so repeat runs skip the one-time builds.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

GBP = int(os.environ.get("NGM_C4_GBP", 1_200_000_000))
N_CHROM = 4
N_READS = int(os.environ.get("NGM_C4_READS", 20_000))
READ_LEN = 150
K = os.environ.get("NGM_C4_K", "14")
SHARDS = os.environ.get("NGM_C4_SHARDS", "4")
MODE = os.environ.get("NGM_C4_MODE", "plain")
WS = os.environ.get("NGM_C4_DIR", "/root/c4ws")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def build_inputs():
    from nextgenmap_tpu.io.encode import decode_seq
    from nextgenmap_tpu.io.simulate import random_genome

    os.makedirs(WS, exist_ok=True)
    ref = f"{WS}/ref.fa"
    if not os.path.exists(ref):
        t0 = time.time()
        span = GBP // N_CHROM
        with open(ref + ".tmp", "w") as f:
            for c in range(N_CHROM):
                g = random_genome(span, seed=100 + c)
                f.write(f">chr{c + 1}\n")
                for s in range(0, span, 1 << 24):
                    f.write(decode_seq(g[s:s + (1 << 24)]))
                    f.write("\n")
                del g
        os.replace(ref + ".tmp", ref)
        log(f"wrote {ref} in {time.time() - t0:.0f}s")

    snp = 0.10 if MODE in ("divergent", "bs") else 0.02
    fq = f"{WS}/reads-{MODE}.fq"
    if not os.path.exists(fq):
        t0 = time.time()
        span = GBP // N_CHROM
        # per-chrom batched simulation to bound memory
        per = N_READS // N_CHROM
        from nextgenmap_tpu.io.simulate import random_genome as rg

        with open(fq + ".tmp", "w") as f:
            for c in range(N_CHROM):
                g = rg(span, seed=100 + c)
                rng = np.random.default_rng(200 + c)
                pos = rng.integers(0, span - READ_LEN, size=per)
                for j in range(per):
                    w = g[pos[j]:pos[j] + READ_LEN].copy()
                    if (w >= 4).any():
                        w = np.where(w >= 4, 0, w)
                    m = rng.random(READ_LEN) < snp
                    w[m] = (w[m] + rng.integers(1, 4, size=int(m.sum()))) % 4
                    strand = int(rng.integers(0, 2))
                    if strand:
                        w = (3 - w)[::-1]
                    if MODE == "bs":
                        # bisulfite: unmethylated C reads as T (80%
                        # conversion) in sequencing orientation of the
                        # original-top strand; the rc view shows G->A
                        conv = (w == 1) & (rng.random(READ_LEN) < 0.8)
                        w = np.where(conv, 3, w)
                    seq = "".join("ACGT"[x] for x in w)
                    f.write(f"@r_{c}_{int(pos[j])}_{strand}\n{seq}\n+\n"
                            f"{'I' * READ_LEN}\n")
                del g
        os.replace(fq + ".tmp", fq)
        log(f"wrote {fq} in {time.time() - t0:.0f}s")
    return ref, fq


def main():
    ref, fq = build_inputs()
    out = f"{WS}/out-{MODE}.sam"
    args = [sys.executable, "-m", "nextgenmap_tpu.cli", "map",
            "-r", ref, "-q", fq, "-o", out,
            "-k", K, "--index-shards", SHARDS, "-t", "4",
            "--max-read-hits", os.environ.get("NGM_C4_H", "0"),
            "--batch-size", os.environ.get("NGM_C4_B", "4096"),
            "--megabatch", os.environ.get("NGM_C4_MB", "1"),
            ]
    if MODE == "bs":
        args += ["--bs-mapping"]
    if MODE in ("divergent", "bs"):
        args += ["-s", "0.5"]
    extra = os.environ.get("NGM_C4_EXTRA", "")
    if extra:
        args += extra.split()
    env = dict(os.environ)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    t0 = time.time()
    # STREAM the CLI's stderr to a sidecar so a timeout doesn't lose all
    # progress evidence (the bs x shards runs are long)
    side = f"{WS}/cli-{MODE}.log"
    try:
        with open(side, "w") as sf:
            p = subprocess.run(args, env=env, stdout=sf, stderr=sf, text=True,
                               timeout=int(os.environ.get("NGM_C4_TIMEOUT",
                                                          5400)))
    except subprocess.TimeoutExpired:
        sys.stderr.write(open(side).read()[-4000:])
        print(json.dumps({"mode": MODE, "error": "timeout"}))
        return
    wall = time.time() - t0
    sys.stderr.write(open(side).read()[-4000:])
    if p.returncode != 0:
        print(json.dumps({"mode": MODE, "error": p.returncode}))
        return
    # streaming rate: parse the progress R/S of the final log lines
    rs = re.findall(r"\((\d+) reads/s", open(side).read())
    # truth accuracy from the SAM
    span = GBP // N_CHROM
    n = mapped = ok = 0
    for line in open(out):
        if line.startswith("@"):
            continue
        f = line.rstrip("\n").split("\t")
        n += 1
        if int(f[1]) & 4:
            continue
        mapped += 1
        _, c, tp, st = f[0].split("_")
        if f[2] == f"chr{int(c) + 1}" and \
                abs(int(f[3]) - 1 - int(tp)) <= 5 and \
                (1 if int(f[1]) & 16 else 0) == int(st):
            ok += 1
    print(json.dumps({
        "mode": MODE, "k": K, "shards": SHARDS,
        "reads": n, "mapped": mapped, "truth_correct": ok,
        "wall_s": round(wall, 1),
        "last_rs": rs[-3:] if rs else None,
    }))


if __name__ == "__main__":
    main()
