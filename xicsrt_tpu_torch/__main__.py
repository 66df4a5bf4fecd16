"""Command-line interface (``xicsrt_tpu/__main__.py``).

The JAX package's flags; the run goes to ``raytrace(config)`` on the CUDA
device, which raises without one. ``--mp`` shards the rays
(``general.shard_rays``) over ``--processes`` shards, by default one a CUDA
device; more shards than CUDA devices raise (``parallel.ray_mesh``).

Examples::

    python -m xicsrt_tpu_torch config.json
    python -m xicsrt_tpu_torch config.json --numiter 10 --seed 0 --images
"""

from __future__ import annotations

import argparse
import logging
import sys

from xicsrt_tpu_torch._version import __version__


def _get_parser():
    parser = argparse.ArgumentParser(
        prog="xicsrt_tpu_torch",
        description=(
            f"xicsrt_tpu_torch version {__version__}\n\n"
            "Perform a raytrace on the CUDA device from the command line.\n"
            "The input is a configuration dictionary in json format\n"
            "(pickle and hdf5 are also supported)."
        ),
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "config_file", type=str, nargs="?", default="config.json",
        help="Path to the configuration file for this run.")
    parser.add_argument(
        "--numruns", type=int, default=None, metavar="N",
        help="Number of runs.")
    parser.add_argument(
        "--numiter", type=int, default=None, metavar="N",
        help="Number of iterations per run.")
    parser.add_argument(
        "--seed", type=int, default=None, metavar="N",
        help="The random seed to use.")
    parser.add_argument(
        "--save", action="store_true", help="Save the results.")
    parser.add_argument(
        "--images", action="store_true", help="Save intersection images.")
    parser.add_argument(
        "--suffix", type=str, default=None, metavar="STR",
        help="A suffix to add to the output files.")
    parser.add_argument(
        "--path", type=str, default=None, metavar="STR",
        help="Directory in which to store output.")
    parser.add_argument(
        "--multiprocessing", "--mp", action="store_true",
        help="Compatibility flag: shard rays over all local devices.")
    parser.add_argument(
        "--processes", "--devices", type=int, default=None, metavar="N",
        help="Number of devices to shard rays over.")
    parser.add_argument(
        "--dtype", type=str, default=None, metavar="DTYPE",
        help="Computation dtype: float32 (default) or float64.")
    parser.add_argument(
        "--version", action="store_true", help="Show the version number.")
    parser.add_argument(
        "--debug", action="store_true", help="Show debugging output.")
    return parser


def run(argv=None):
    args = _get_parser().parse_args(argv)
    if args.version:
        print(__version__)
        return 0

    logging.basicConfig(
        level=logging.DEBUG if args.debug else logging.INFO,
        format="%(name)s: %(message)s",
    )

    from xicsrt_tpu_torch import io as xio
    from xicsrt_tpu_torch import raytrace

    config = xio.load_config(args.config_file)
    general = config.setdefault("general", {})
    if args.numruns is not None:
        general["number_of_runs"] = args.numruns
    if args.numiter is not None:
        general["number_of_iter"] = args.numiter
    if args.seed is not None:
        general["random_seed"] = args.seed
    if args.path is not None:
        general["output_path"] = args.path
    if args.suffix is not None:
        general["output_suffix"] = args.suffix
    if args.save:
        general["save_results"] = True
        general["save_config"] = True
    if args.images:
        general["save_images"] = True
    if args.dtype is not None:
        general["dtype"] = args.dtype
    if args.multiprocessing or args.processes:
        general["shard_rays"] = True
        if args.processes:
            general["devices"] = args.processes

    raytrace(config)
    return 0


if __name__ == "__main__":
    sys.exit(run())
