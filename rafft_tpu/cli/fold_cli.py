"""`rafft` command — fold a sequence and print structures.

Flag surface and output protocol mirror the reference CLI
(/root/reference/bin/rafft:7-79), including flags that are parsed but
deliberately unused there (-mb, -p, --bp_only) and the differing CLI
default for --max_branch (1000) vs the API default (100).
"""

from __future__ import annotations

import argparse
import sys


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    parser.add_argument('--sequence', '-s', help="sequence")
    parser.add_argument('--seq_file', '-sf', help="sequence file")
    parser.add_argument('--n_mode', '-n', type=int, default=100,
                        help="Number of positional lags to search for stems")
    parser.add_argument('--max_stack', '-ms', type=int, default=1,
                        help="number of stored structures (default=1)")
    parser.add_argument('--min_nrj', '-mn', type=float, default=0,
                        help="minimum loop energy to be formed")
    parser.add_argument('--min_bp', '-mb', type=int, default=1,
                        help="minimum bp number to be detectable")
    parser.add_argument('--min_hp', '-mh', type=int, default=3,
                        help="minimum unpaired positions in hairpins")
    parser.add_argument('--pad', '-p', type=float, default=1.0,
                        help="padding, a normalization constant for the autocorrelation")
    parser.add_argument('--max_branch', type=int, default=1000,
                        help="maximum branches to explor")
    parser.add_argument('--bp_only', action="store_true", help="don't use the NRJ")
    parser.add_argument('--bench', action="store_true", help="output for benchmarks")
    parser.add_argument('-tr', '--traj', action="store_true",
                        help="output full trajectories")
    parser.add_argument('--temp', type=float, default=37.0, help="temperature")
    parser.add_argument('-gc', '--gc_wei', type=float, default=3.00, help="GC weight")
    parser.add_argument('-au', '--au_wei', type=float, default=2.00, help="AU weight")
    parser.add_argument('-gu', '--gu_wei', type=float, default=1.00, help="GU weight")
    parser.add_argument('--nono', action="store_true",
                        help="Use the tree-keeping (nono) engine instead.")
    parser.add_argument('--engine', choices=("cpu", "jax"), default="cpu",
                        help="fold engine: cpu (sequential parity oracle) or "
                             "jax (batched device engine)")
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_arguments(argv)
    assert args.sequence is not None or args.seq_file is not None, \
        "error, the sequence is missing!"

    if args.sequence is not None:
        sequence = args.sequence
    else:
        sequence = "".join(
            l.strip() for l in open(args.seq_file) if not l.startswith(">")
        ).replace("T", "U")
    len_seq = len(sequence)

    if args.nono:
        from rafft_tpu.engine.fold_nono import fold as fold_nono
        results, root = fold_nono(
            sequence, args.n_mode, args.max_stack, args.max_branch,
            args.min_hp, args.min_nrj, args.traj, args.temp,
            args.gc_wei, args.au_wei, args.gu_wei)
    elif args.engine == "jax":
        from rafft_tpu.engine.fold_jax import fold_one
        results = fold_one(
            sequence, nb_mode=args.n_mode, max_stack=args.max_stack,
            max_branch=args.max_branch, min_hp=args.min_hp,
            min_nrj=args.min_nrj, traj=args.traj, temp=args.temp,
            gc_wei=args.gc_wei, au_wei=args.au_wei, gu_wei=args.gu_wei)
    else:
        from rafft_tpu.engine.fold_cpu import fold
        results = fold(
            sequence, args.n_mode, args.max_stack, args.max_branch,
            args.min_hp, args.min_nrj, args.traj, args.temp,
            args.gc_wei, args.au_wei, args.gu_wei)

    if args.traj:
        final_struct, trajectory = results
    else:
        final_struct = results

    if not args.traj:
        if not args.bench:
            print(f"{sequence}")
        for struct in final_struct:
            str_struct = struct.str_struct
            nrj_pred = struct.energy
            if args.bench:
                print(sequence, len_seq, str_struct, f"{nrj_pred:6.1f}",
                      str_struct.count("("))
            else:
                print(f"{str_struct} {nrj_pred:6.1f}")
        if args.nono:
            print("====================== Full Tree ========================")
            print(root)
    else:
        print(f"{sequence}")
        for si, fold_step in enumerate(trajectory):
            print("# {:-^20}".format(si))
            for struct in fold_step:
                print(f"{struct.str_struct} {struct.energy:6.1f}")


if __name__ == '__main__':
    main()
