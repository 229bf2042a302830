"""Command-line entry: python -m pav_tpu --ref ref.fa --assemblies asm.tsv

The CLI analog of the reference's runlocal/snakemake invocation
(NATIVE_INSTALL.md:68-116): one process, one engine, VCF per sample.
"""

import argparse
import json
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        prog='pav_tpu',
        description='GPU-accelerated assembly-to-reference variant calling engine '
                    '(PAV semantics, JAX + CUDA)')
    parser.add_argument('--ref', required=True, help='Reference FASTA')
    parser.add_argument('--assemblies', required=True,
                        help='Assembly table TSV/CSV (NAME + HAP_* columns)')
    parser.add_argument('--config', default=None, help='config.json path')
    parser.add_argument('--run-dir', default='pav_run', help='Artifact directory')
    parser.add_argument('--sample', action='append', default=None,
                        help='Run only this sample (repeatable)')
    parser.add_argument('--set', action='append', default=[], metavar='KEY=VAL',
                        help='Config override (repeatable)')
    parser.add_argument('--resume', action='store_true',
                        help='Resume from stage artifacts in the run dir')
    parser.add_argument('--profile-dir', default=None,
                        help='Write a JAX profiler trace here')
    # Multi-host cohort fan-out (reference: Snakemake cluster profiles,
    # NATIVE_INSTALL.md:68-103). Launch one process per host with the same
    # coordinator; samples shard round-robin across processes.
    parser.add_argument('--coordinator', default=None, metavar='HOST:PORT',
                        help='jax.distributed coordinator (process 0 host)')
    parser.add_argument('--num-processes', type=int, default=1)
    parser.add_argument('--process-id', type=int, default=0)
    parser.add_argument('--cohort-timeout', type=float, default=None,
                        metavar='SECONDS',
                        help='bound for cohort barriers/gathers '
                             '(default $PAV_COHORT_TIMEOUT_S or 600)')
    parser.add_argument('--ship-artifacts', action='store_true',
                        help='replicate every VCF to every process through '
                             'the coordination store (no shared FS needed)')
    parser.add_argument('--no-keep-going', action='store_true',
                        help='abort the cohort on the first failed sample '
                             'or dead member (default: record and continue, '
                             'like the reference profile\'s --keep-going)')
    args = parser.parse_args(argv)

    # Engine processes churn large short-lived buffers; keeping freed pages in
    # the heap avoids munmap/refault cycles (critical on lazily-restored VMs).
    from .runtime import enable_compile_cache, retain_heap
    retain_heap(0)
    # Sets configuration only: safe before jax.distributed.initialize below.
    enable_compile_cache()

    overrides = {}
    if args.config:
        with open(args.config) as fh:
            overrides.update(json.load(fh))
    for item in args.set:
        key, _, val = item.partition('=')
        overrides[key] = val

    if args.coordinator and args.num_processes > 1:
        # Must run before anything touches jax (engine imports create device
        # constants, which would initialize the backend pre-distributed).
        from .parallel.multihost import gather_manifest, init, shard_samples
        keep_going = not args.no_keep_going
        cohort = init(args.coordinator, args.num_processes, args.process_id,
                      keep_going=keep_going)
        if args.cohort_timeout is not None:
            cohort.timeout_s = args.cohort_timeout
        from .assembly_table import read_assembly_table
        from .pipeline import run
        names = list(read_assembly_table(args.assemblies).index)
        if args.sample:
            names = [n for n in names if n in set(args.sample)]
        mine = shard_samples(names, args.process_id, args.num_processes)
        local = {}
        for name in mine:   # one sample per run(): independent keep-going jobs
            try:
                res = run(args.ref, args.assemblies, config=overrides,
                          run_dir=args.run_dir, samples=[name],
                          resume=args.resume,
                          profile_dir=args.profile_dir)[name]
            except Exception as ex:
                if not keep_going:
                    raise
                print(f'[cohort] sample {name} failed: {ex!r} (keep-going)',
                      file=sys.stderr)
                local[name] = {'error': f'{type(ex).__name__}: {ex}',
                               'process': args.process_id}
                continue
            local[name] = {'vcf': res['vcf'], 'process': args.process_id}
            if args.ship_artifacts:
                with open(res['vcf'], 'rb') as fh:
                    cohort.publish_bytes(f'vcf/{name}', fh.read())
        from .parallel.multihost import finalize
        manifest = gather_manifest(
            cohort, local, names, run_dir=args.run_dir,
            log=lambda m: print(m, file=sys.stderr), keep_going=keep_going,
            ship_artifacts=args.ship_artifacts)
        finalize(cohort, manifest)
        failed = 0
        for asm_name in sorted(manifest):
            entry = manifest[asm_name]
            if entry.get('error'):
                failed += 1
                print(f'{asm_name}: ERROR {entry["error"]} '
                      f'(process {entry["process"]})')
            else:
                print(f'{asm_name}: {entry["vcf"]} '
                      f'(process {entry["process"]})')
        return 1 if failed else 0

    from .pipeline import run
    results = run(args.ref, args.assemblies, config=overrides,
                  run_dir=args.run_dir, samples=args.sample,
                  resume=args.resume, profile_dir=args.profile_dir)
    for asm_name, res in results.items():
        print(f'{asm_name}: {res["vcf"]}')
    return 0


if __name__ == '__main__':
    sys.exit(main())
