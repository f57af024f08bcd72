"""
Run one cell of the benchmark on this machine's CUDA card(s):

    python3 gpubench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the comparisons that decide ``correct`` as the last lines of
standard error and the result as the last line of standard output. Exits
non-zero without a result when there is no CUDA card (or fewer than the cell
asks for), when JAX or the JAX package is loaded, or when anything fails.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def cache_environment():
    """Keep every build cache of the run inside the checkout, at fixed
    paths (the port builds its kernels under ``build/kernels/`` itself)."""
    os.environ.setdefault('TRITON_CACHE_DIR', os.path.join(ROOT, 'build', 'triton'))
    os.environ.setdefault('TORCH_EXTENSIONS_DIR',
                          os.path.join(ROOT, 'build', 'torch_extensions'))
    os.environ.setdefault('CUDA_CACHE_PATH', os.path.join(ROOT, 'build', 'nv_cache'))
    os.environ['USE_FLAX'] = '0'
    os.environ['USE_JAX'] = '0'


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    cache_environment()

    from gpubench import harness
    cell = harness.load_json(harness.cell_file(args.workload))
    import torch
    torch.set_num_threads(min(4, torch.get_num_threads()))
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell['chips']:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'{args.workload} needs {cell["chips"]} CUDA card(s); this machine '
              f'has {found}', file=sys.stderr)
        return 2
    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), device='cuda:0', t_start=T_START)
    except harness.ImportGuardError as e:
        print(str(e), file=sys.stderr)
        return 3
    for name, c in result['compared'].items():
        print(f'compared {name}: {c["value"]!r} (limit {c["limit"]!r})',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
