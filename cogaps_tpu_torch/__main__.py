"""Command-line entry point: ``python -m cogaps_tpu_torch``.

The L7 pipeline layer — the analog of the reference's containerized
nextflow process, whose parameter surface this mirrors
(reference: nextflow/main.nf:1-59: niterations/npatterns/sparse/
distributed/nsets/nthreads + input conversion; conversions here are
native h5/h5ad/10x readers, io/h5.py). The port's copy of
cogaps_tpu/__main__.py, with the same arguments, outputs and summary
line, and one more option: ``--device`` (default ``cuda``). A run goes to
the card unless ``--device cpu`` asks for the CPU; without a GPU the
default fails as CoGAPS() does.
"""

from __future__ import annotations

import argparse
import json
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cogaps_tpu_torch",
        description="CoGAPS on PyTorch and CUDA: Bayesian non-negative "
                    "matrix factorization (D ~ A P^T with an atomic prior)")
    p.add_argument("data", help="input matrix: csv/tsv/mtx/gct/h5/h5ad")
    p.add_argument("-o", "--output", default="cogaps_result",
                   help="output prefix (.npz bundle + CSV matrices)")
    p.add_argument("--n-patterns", type=int, default=7)
    p.add_argument("--n-iterations", type=int, default=50000)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--sparse", action="store_true",
                   help="use the sparse data model (scCoGAPS-style)")
    p.add_argument("--distributed", choices=["genome-wide", "single-cell"],
                   default=None)
    p.add_argument("--n-sets", type=int, default=4)
    p.add_argument("--transpose", action="store_true")
    p.add_argument("--uncertainty", default=None,
                   help="uncertainty matrix file (dense formats only)")
    p.add_argument("--checkpoint-interval", type=int, default=0)
    p.add_argument("--checkpoint-file", default=None,
                   help="resume from this checkpoint")
    p.add_argument("--output-frequency", type=int, default=500)
    p.add_argument("--csv", action="store_true",
                   help="also write Amean/Asd/Pmean/Psd CSV files")
    p.add_argument("--quiet", action="store_true")
    p.add_argument("--debug", action="store_true",
                   help="runtime sampler-invariant assertions "
                        "(the GAPS_DEBUG analog)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; the CPU "
                        "only when asked for, e.g. --device cpu)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from . import CoGAPS
    from .params import CogapsParams

    params = CogapsParams(
        n_patterns=args.n_patterns,
        n_iterations=args.n_iterations,
        seed=args.seed,
        sparse_optimization=args.sparse,
        distributed=args.distributed,
        n_sets=args.n_sets,
        output_frequency=args.output_frequency,
        checkpoint_interval=args.checkpoint_interval,
        debug_checks=args.debug,
    )
    unc = None
    if args.uncertainty:
        from .io import parsers
        unc, _, _ = parsers.read_matrix(args.uncertainty)

    res = CoGAPS(args.data, params, uncertainty=unc,
                 transpose_data=args.transpose,
                 checkpoint_in_file=args.checkpoint_file,
                 messages=not args.quiet, device=args.device)

    res.save(args.output + ".npz")
    if args.csv:
        res.to_csv(args.output)
    summary = {
        "output": args.output + ".npz",
        "nPatterns": int(res.Amean.shape[1]),
        "meanChiSq": float(res.mean_chi_sq),
        "totalUpdates": int(res.diagnostics.get("totalUpdates", 0)),
        "totalRunningTime": float(
            res.diagnostics.get("totalRunningTime", 0.0)),
    }
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
