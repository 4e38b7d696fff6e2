"""Card times of the traversal kernels on their headline waves, for timing
two checkouts against each other.

  python paperrenderer_tpu_torch/utils/walk_bench.py \\
      [--root DIR] [--rounds N] [--out FILE] [--same-as FILE]

times every case of ``probes.headline_waves`` (1080p) in the checkout at
``--root`` (default: the one that holds this file), with that checkout's
own build of ``csrc/trace.cu``: ``rounds`` times each,
``profiling.device_time`` (CUDA events behind a sleep kernel). Two
checkouts (e.g. a parent commit unpacked with ``git archive``) are
compared by running this on each in turns on one card (parent, change,
change, parent), each run with ``--same-as`` the first run's ``--out``:
every case's outputs must then hash to the same digest, or the run fails.

Prints one JSON line per case ({case: [ms per round], "live": the share of
its rays that are live, "digest": sha256 of its outputs' bytes}), one with
the registers, spills and stack frame of each kernel of the build (ptxas),
the card (nvidia-smi name and power limit), and last {"ok": ...}.
"""

from __future__ import annotations

import os
import sys

if __name__ == "__main__":   # run as a file: its folder (utils/, with its
    here = os.path.dirname(os.path.abspath(__file__))   # own logging and
    sys.path[:] = [p for p in sys.path   # random) must not shadow the
                   if os.path.abspath(p or ".") != here]   # standard library

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402

REPS = 10           # timed launches a measurement


def _args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--root", default=None,
                    help="the checkout whose package is timed")
    ap.add_argument("--out", default=None, help="also write the lines here")
    ap.add_argument("--same-as", default=None,
                    help="an earlier run's --out: every case must match "
                         "its digest")
    return ap.parse_args()


def ptxas_table(log: str) -> dict:
    """{kernel: {registers, spill_stores, spill_loads, stack, smem}} from a
    ptxas -v log; a kernel is named by its function and template flags
    (e.g. trace_kernel<10110>)."""
    table, name = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            k = re.search(r"(trace_kernel_fetch|trace_kernel|bundle_kernel)"
                          r"(I((?:Lb[01]E)+)E)?", m.group(1))
            flags = "".join(re.findall(r"Lb([01])E", k.group(3) or ""))
            name = k.group(1) + (f"<{flags}>" if flags else "")
            table[name] = {}
        elif name and "stack frame" in line:
            n = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            table[name].update(stack=n[0], spill_stores=n[1], spill_loads=n[2])
        elif name and "Used" in line and "registers" in line:
            table[name]["registers"] = int(
                re.search(r"Used (\d+) registers", line).group(1))
            sm = re.search(r"(\d+) bytes smem", line)
            table[name]["smem"] = int(sm.group(1)) if sm else 0
    return table


def main() -> int:
    args = _args()
    root = os.path.abspath(args.root or os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..", ".."))
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("walk_bench: no CUDA device", file=sys.stderr)
        return 2
    from paperrenderer_tpu_torch.ops import trace_kernel as TK
    from paperrenderer_tpu_torch.utils import cuda_build
    from paperrenderer_tpu_torch.utils import probes as PR
    from paperrenderer_tpu_torch.utils.profiling import device_time

    want = {}
    if args.same_as:
        for line in open(args.same_as):
            j = json.loads(line) if line.startswith("{") else {}
            if "digest" in j:
                want[next(iter(j))] = j["digest"]
    out = open(args.out, "a") if args.out else None

    def emit(line):
        """Print a line (a JSON object or text), and append it to --out
        at once, so a run cut short keeps what it measured."""
        line = line if isinstance(line, str) else json.dumps(line)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    TK._lib()
    emit({"root": root,
          "ptxas": ptxas_table(cuda_build.BUILD_INFO["trace"]["log"])})
    ok = True
    for case, fn in PR.headline_waves("cuda").items():
        digest = hashlib.sha256()
        for t in PR.tensors_of(fn()):
            digest.update(t.contiguous().view(torch.uint8).cpu().numpy())
        act = getattr(fn, "keywords", {}).get("active")
        live = 1.0 if act is None else float(act.float().mean())
        times = [device_time(fn, iters=REPS) * 1e3
                 for _ in range(args.rounds)]
        same = want.get(case, digest.hexdigest()) == digest.hexdigest()
        ok &= same
        emit({case: times, "live": live, "digest": digest.hexdigest(),
              "same": same})
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    emit(smi)
    emit({"ok": ok, "device": torch.cuda.get_device_name(0),
          "nvidia_smi": smi})
    if out is not None:
        out.close()
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
