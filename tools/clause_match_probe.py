"""Time clause_match on the production serve batch at serve_route's K.

    python3 tools/clause_match_probe.py [--seed 0] [--baseline-cu FILE]
                                        [--qpb N,N,...]

Needs one CUDA card. Builds the kernels, runs `chip_smoke.py`'s phase 3
(the production-shape deployment, its solves and two serve batches), and
times `ops.clause_match` on the first serve batch (4096 queries over a
2^17-term vocabulary, Wv = 4096) against: the 128 deployed clauses; the
deployment's 2^16 candidate singletons and pairs (serve_route's K); and
both of those under one random permutation of the token ids, applied to
queries and clauses alike (the answers must be identical). Each time is the
median of 20 calls by CUDA events. Then the device time per call
(`chip_smoke.graph_ms`: 20 calls in one CUDA graph, so the wrapper's host
work drops out) of the whole kernel, of its first pass alone (the compact
clause table, `clause_match.clause_tokens`), and with --qpb of the whole
kernel for each given number of queries per block of its second pass that
fits in shared memory, in place of `clause_match.plan`'s.

With --baseline-cu, FILE is another version of `csrc/clause_match.cu` with
the entry `clause_match_launch(q, c, out, B, K, Wv, stream)` (for example
an earlier commit's, from `git show <commit>:src/repro_torch/kernels/csrc/
clause_match.cu`). It is built alone with nvcc and timed on the same
inputs in turns with the current kernel (current, baseline, baseline,
current); its answers must equal the current kernel's. Prints one line per
setting, then the card.
"""
from __future__ import annotations

import argparse
import ctypes
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT / "tools"))

import chip_smoke as cs  # noqa: E402
import nvcc_lib  # noqa: E402
from repro_torch.kernels import _build, ops  # noqa: E402
from repro_torch.kernels import clause_match as cm  # noqa: E402


def baseline_fn(path: Path):
    lib = nvcc_lib.load(path, "clause-match-baseline")
    fn = lib.clause_match_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(q: torch.Tensor, cl: torch.Tensor) -> torch.Tensor:
        out = torch.empty(q.shape[0], dtype=torch.bool, device=q.device)
        code = fn(q.data_ptr(), cl.data_ptr(), out.data_ptr(), q.shape[0],
                  cl.shape[0], q.shape[1], torch.cuda.current_stream().cuda_stream)
        if code:
            raise RuntimeError(f"baseline clause_match launch failed ({code})")
        return out
    return run


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--baseline-cu", type=Path)
    ap.add_argument("--qpb", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("clause_match_probe: no CUDA device", file=sys.stderr)
        return 1
    _build.lib()
    base = baseline_fn(args.baseline_cu) if args.baseline_cu else None
    p3 = cs.phase3(args.seed, {})
    x = cs.serve_route_inputs(p3)
    deployed = p3["engine"]._live.clause_bits
    # the deployed clauses are the selected candidates in index order
    rows = torch.tensor(sorted(p3["greedy_order"]), device=deployed.device)
    cs.check(torch.equal(x["cl"][rows], deployed),
             "the deployed clauses are not the selected candidates")
    settings = [("deployed", x["q"], deployed),
                ("deployed, permuted", x["q_perm"], x["cl_perm"][rows]),
                ("candidates", x["q"], x["cl"]),
                ("candidates, permuted", x["q_perm"], x["cl_perm"])]
    answers = {}
    for name, q, cl in settings:
        out = ops.clause_match(q, cl)
        answers[name] = out
        line = (f"clause_match {name} [B {q.shape[0]}, K {cl.shape[0]}, Wv "
                f"{q.shape[1]}], {float(out.float().mean()):.4f} eligible: ")
        if base is None:
            line += f"{cs.time_ms(lambda: ops.clause_match(q, cl), 20):.4f} ms"
        else:
            cs.check(torch.equal(base(q, cl), out), f"baseline differs ({name})")
            t = [cs.time_ms(f, 20) for f in (lambda: ops.clause_match(q, cl),
                                             lambda: base(q, cl),
                                             lambda: base(q, cl),
                                             lambda: ops.clause_match(q, cl))]
            line += (f"current {t[0]:.4f} / {t[3]:.4f} ms, baseline "
                     f"{t[1]:.4f} / {t[2]:.4f} ms")
        print(line, flush=True)
        print(f"  device time per call {cs.graph_ms(lambda: ops.clause_match(q, cl)):.4f}"
              f" ms, pass A alone {cs.graph_ms(lambda: cm.clause_tokens(cl)):.4f} ms"
              f" (one CUDA graph of 20 calls)", flush=True)
        own = cm.plan
        for qpb in (int(v) for v in args.qpb.split(",") if v and
                    cm.smem_rows(int(v)) * 4 * q.shape[1] + cm.FLAG_BYTES
                    <= cm.SMEM_BYTES):
            cm.plan = lambda b, k, wv, sms, qpb=qpb: qpb
            cs.check(torch.equal(ops.clause_match(q, cl), out), f"qpb {qpb} differs")
            print(f"  {qpb} queries per block: "
                  f"{cs.graph_ms(lambda: ops.clause_match(q, cl)):.4f} ms", flush=True)
        cm.plan = own
    for a, b in (("deployed", "deployed, permuted"),
                 ("candidates", "candidates, permuted")):
        cs.check(torch.equal(answers[a], answers[b]),
                 f"{a}: the answers change under the permutation")
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
