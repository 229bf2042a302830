"""Multi-host distribution: share-nothing sample/haplotype fan-out across
processes with jax.distributed coordination.

The reference distributes pipeline rules across a cluster through Snakemake
profiles (NATIVE_INSTALL.md:68-103, profiles/default/config.yaml): every job is
share-nothing and files are the interchange. This engine keeps that shape at
the top level — each process owns a deterministic shard of the sample table
and runs the full engine on its own device(s), with the
device-mesh layer (parallel.mesh) sharding batched kernels inside each host —
and replaces the filesystem rendezvous with the jax.distributed coordination
service: a key-value store for artifact exchange and named barriers for stage
fences.

Failure semantics follow the reference's ``--keep-going`` profile default
(profiles/default/config.yaml:2-5): per-sample jobs are independent, so one
failed sample — or one dead member process — must not abort the cohort. A
failed sample is recorded in the manifest with an ``error`` field; a member
that never publishes its shard is marked ``unreachable`` after a bounded wait
(``PAV_COHORT_TIMEOUT_S`` / ``timeout_s``), and the surviving processes still
return the full manifest for every sample they can account for. Two
failures remain fatal by construction: process 0 (it hosts the coordination
service itself, exactly as the reference's main Snakemake process does) and
a member that dies before JAX backend initialization completes (the global
device-topology exchange blocks every process's backend init on every
member's participation).

Artifact placement: each sample's VCF is written on the local disk of
whichever process ran it (the manifest records the owning process). On a
shared filesystem that is already a complete output contract. Without one,
pass ``ship_artifacts=True`` (CLI: ``--ship-artifacts``) to also publish each
VCF's bytes through the coordination KV store so every process materializes
the whole cohort's VCFs locally — the in-memory analog of the reference's
shared-FS file interchange.

Works on any backend (the coordination service is backend-independent), so the
cohort path is testable on CPU hosts. On GPU hosts each process owns exactly
one card (see :func:`init`): a JAX process reserves most of a card's memory,
so two processes on one card would fail.
"""

import base64
import json
import os
import socket
import subprocess
import time

import numpy as np

_RAISE = object()

# KV-store values are strings; ship binary artifacts as base64 in bounded
# chunks so a large VCF cannot hit a single-value size limit.
_CHUNK = 1 << 20


def local_gpu_count():
    """Number of GPUs this host offers JAX, read without starting JAX's
    backend (0 when JAX_PLATFORMS excludes the GPU or there is none)."""
    platforms = os.environ.get('JAX_PLATFORMS', '')
    if platforms and not any(p in platforms for p in ('cuda', 'gpu')):
        return 0
    visible = os.environ.get('CUDA_VISIBLE_DEVICES')
    if visible is not None:
        return len([v for v in visible.split(',') if v.strip()])
    try:
        out = subprocess.run(['nvidia-smi', '-L'], capture_output=True,
                             text=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return 0
    return sum(1 for line in out.splitlines() if line.startswith('GPU '))


def init(coordinator, num_processes, process_id, keep_going=True):
    """Initialize jax.distributed for a cohort run.

    On a GPU host, process p owns local card p mod (cards on the host);
    processes that would share a card fail with an error instead.

    :param coordinator: 'host:port' of process 0.
    :param keep_going: run the coordination client in recoverable mode so a
        dead member does NOT terminate the survivors (without it, the JAX
        coordination service fatally aborts every task when one stops
        heartbeating — the opposite of the reference's --keep-going).
    """
    import jax

    if keep_going:
        jax.config.update('jax_enable_recoverability', True)
    cards = local_gpu_count()
    card = process_id % cards if cards else None
    jax.distributed.initialize(
        coordinator, num_processes, process_id,
        local_device_ids=None if card is None else [card])
    cohort = Cohort(num_processes, process_id)
    if card is not None:
        owners = cohort.allgather_obj('card', [socket.gethostname(), card])
        shared = [p for p, o in enumerate(owners)
                  if p != process_id and o == owners[process_id]]
        if shared:
            raise RuntimeError(
                f'cohort process {process_id} would share GPU {card} on '
                f'{owners[process_id][0]} with process(es) {shared}: run at '
                'most one cohort process per card')
    return cohort


def shard_samples(sample_names, process_id, num_processes):
    """Deterministic round-robin shard of the sample table (the reference's
    per-sample cluster fan-out: one wildcard job per sample)."""
    return [s for i, s in enumerate(sorted(sample_names))
            if i % num_processes == process_id]


class Cohort:
    """Cross-process coordination for a sharded cohort run.

    :param timeout_s: Default bound for every blocking wait (barriers,
        fetches, fences). ``None`` reads ``PAV_COHORT_TIMEOUT_S`` (default
        600 s). Per-call ``timeout_s`` arguments override it.
    """

    def __init__(self, num_processes, process_id, timeout_s=None):
        from jax._src import distributed

        self.num_processes = int(num_processes)
        self.process_id = int(process_id)
        if timeout_s is None:
            timeout_s = float(os.environ.get('PAV_COHORT_TIMEOUT_S', 600))
        self.timeout_s = float(timeout_s)
        self._client = distributed.global_state.client
        if self._client is None:
            raise RuntimeError('jax.distributed is not initialized')

    def _ms(self, timeout_s):
        return int((self.timeout_s if timeout_s is None else timeout_s) * 1000)

    # -------------------------------------------------------------- barriers

    def barrier(self, name, timeout_s=None):
        """All processes wait at a named fence (stage edge). Raises on
        timeout — use :meth:`fence` when dead members must be tolerated."""
        self._client.wait_at_barrier(str(name), self._ms(timeout_s))

    def fence(self, name, timeout_s=None):
        """Dead-member-tolerant barrier: publish arrival, then wait for each
        peer up to the timeout. Returns the set of process ids that arrived —
        a member that died before reaching the fence is simply absent, and
        the survivors proceed (reference analog: Snakemake --keep-going
        finishing independent jobs after one fails)."""
        self.publish(f'fence/{name}/{self.process_id}', True)
        arrived = set()
        # One shared deadline across all peers: with k dead members a
        # sequential per-key timeout would stall k * timeout_s; a fetch of an
        # already-published key returns immediately regardless of its
        # timeout, so only genuinely-absent peers consume wall time.
        deadline = time.time() + (self.timeout_s if timeout_s is None
                                  else float(timeout_s))
        for p in range(self.num_processes):
            left = max(0.05, deadline - time.time())
            if self.fetch(f'fence/{name}/{p}', left, default=None) is not None:
                arrived.add(p)
        return arrived

    # ------------------------------------------------------------- exchange

    def publish(self, key, obj):
        """Publish a JSON-serializable object under a namespaced key."""
        self._client.key_value_set(f'pav/{key}', json.dumps(obj))

    def fetch(self, key, timeout_s=None, default=_RAISE):
        """Blocking fetch of a published object. With ``default``, a timeout
        (publisher dead or late) returns it instead of raising."""
        try:
            val = self._client.blocking_key_value_get(
                f'pav/{key}', self._ms(timeout_s))
        except Exception:
            if default is _RAISE:
                raise
            return default
        return json.loads(val)

    def publish_bytes(self, key, data):
        """Publish an artifact's bytes (chunked base64) through the KV store
        — the non-shared-FS transport for run outputs."""
        b64 = base64.b64encode(bytes(data)).decode('ascii')
        chunks = [b64[i:i + _CHUNK] for i in range(0, len(b64), _CHUNK)] or ['']
        for i, chunk in enumerate(chunks):
            self._client.key_value_set(f'pav/bytes/{key}/{i}', chunk)
        self.publish(f'bytes/{key}/n', len(chunks))

    def fetch_bytes(self, key, timeout_s=None, default=_RAISE):
        """Fetch bytes published with :meth:`publish_bytes`."""
        n = self.fetch(f'bytes/{key}/n', timeout_s, default=None)
        if n is None:
            if default is _RAISE:
                raise TimeoutError(f'artifact bytes never published: {key}')
            return default
        parts = [self._client.blocking_key_value_get(
            f'pav/bytes/{key}/{i}', self._ms(timeout_s)) for i in range(n)]
        return base64.b64decode(''.join(parts))

    def allgather_obj(self, name, obj, timeout_s=None, tolerate_missing=False):
        """Gather one JSON-serializable object per process, ordered by
        process id (the cross-host reduction that replaces the reference's
        per-sample file concatenation). With ``tolerate_missing``, a process
        that never publishes yields ``None`` in its slot after the timeout
        instead of aborting the gather."""
        self.publish(f'{name}/{self.process_id}', obj)
        if not tolerate_missing:
            return [self.fetch(f'{name}/{p}', timeout_s)
                    for p in range(self.num_processes)]
        # Shared deadline (see fence): k dead publishers cost one timeout
        # total, not k timeouts.
        deadline = time.time() + (self.timeout_s if timeout_s is None
                                  else float(timeout_s))
        return [self.fetch(f'{name}/{p}', max(0.05, deadline - time.time()),
                           default=None)
                for p in range(self.num_processes)]


def gather_manifest(cohort, local, all_samples, run_dir=None, log=None,
                    keep_going=True, ship_artifacts=False):
    """Gather per-process manifests into the cohort manifest, tolerating
    failed samples and dead members (keep-going semantics).

    :param local: this process's {sample: entry} manifest shard. Entries for
        failed samples carry an ``error`` key.
    :param all_samples: the full cohort sample list — used to attribute
        samples owned by an unreachable process.
    :param ship_artifacts: fetch VCF bytes published by other processes and
        materialize them under ``run_dir`` (non-shared-FS output contract).
    :return: manifest for every sample; unreachable processes' samples are
        marked ``{'error': 'process unreachable', ...}``.
    """
    shards = cohort.allgather_obj('cohort_manifest', local,
                                  tolerate_missing=keep_going)
    manifest = {}
    for pid, shard in enumerate(shards):
        if shard is None:
            if log:
                log(f'[cohort] process {pid} unreachable; marking its '
                    f'samples failed (keep-going)')
            for s in shard_samples(all_samples, pid, cohort.num_processes):
                manifest[s] = {'error': 'process unreachable', 'process': pid}
            continue
        manifest.update(shard)

    if ship_artifacts and run_dir is not None:
        for sample, entry in manifest.items():
            if entry.get('error') or entry.get('process') == cohort.process_id:
                continue
            data = cohort.fetch_bytes(f'vcf/{sample}', default=None)
            if data is None:
                entry['error'] = 'artifact bytes unavailable'
                continue
            path = os.path.join(run_dir, f'{sample}.vcf.gz')
            os.makedirs(run_dir, exist_ok=True)
            with open(path, 'wb') as fh:
                fh.write(data)
            entry['vcf'] = path

    # Tolerant end-of-run fence (never deadlocks on a dead member).
    if keep_going:
        cohort.fence('cohort_done')
    else:
        cohort.barrier('cohort_done')
    return manifest


def finalize(cohort, manifest=None):
    """Ordered teardown for recoverable cohorts. Recoverable-mode clients
    skip the coordination service's shutdown barrier, so the leader (process
    0, which hosts the service) could tear it down while another member's
    disconnect RPC is in flight — that member then dies with a fatal
    coordination error despite a fully successful run. Non-leaders
    disconnect first (after publishing a goodbye); the leader waits for the
    goodbyes of every member the manifest does not already record as
    unreachable, grants a short grace period for their disconnects to land,
    and only then shuts the service down."""
    import time

    import jax

    if cohort.process_id != 0:
        cohort.publish(f'bye/{cohort.process_id}', True)
        jax.distributed.shutdown()
        return
    unreachable = set()
    if manifest:
        unreachable = {e.get('process') for e in manifest.values()
                       if e.get('error') == 'process unreachable'}
    for p in range(1, cohort.num_processes):
        if p not in unreachable:
            cohort.fetch(f'bye/{p}', default=None)
    time.sleep(1.0)
    jax.distributed.shutdown()


def run_cohort(cohort, ref_store, assemblies, run_dir, config=None, log=None,
               keep_going=True, ship_artifacts=False):
    """Run the engine on this process's sample shard; gather the cohort
    manifest (sample -> VCF path + per-type call counts) on every process.

    :param assemblies: {sample: {hap: SeqStore}} for the WHOLE cohort; each
        process runs only its shard.
    :param keep_going: record per-sample failures (and dead members) in the
        manifest instead of aborting — the reference's --keep-going default.
    :return: manifest dict for all samples across all processes.
    """
    from ..pipeline import Pipeline

    mine = shard_samples(list(assemblies), cohort.process_id,
                         cohort.num_processes)
    pipeline = Pipeline(ref_store, config or {}, run_dir=run_dir, log=log)
    local = {}
    for sample in mine:
        try:
            result = pipeline.run_sample(sample, assemblies[sample])
        except Exception as ex:          # keep-going: independent sample jobs
            if not keep_going:
                raise
            if log:
                log(f'[cohort] sample {sample} failed: {ex!r} (keep-going)')
            local[sample] = {'error': f'{type(ex).__name__}: {ex}',
                             'process': cohort.process_id}
            continue
        counts = {f'{t}_{tier}': int(df.shape[0])
                  for (t, tier), df in result['merged'].items()}
        vcf_path = os.path.join(run_dir, f'{sample}.vcf.gz')
        local[sample] = {
            'vcf': vcf_path,
            'process': cohort.process_id,
            'counts': counts,
        }
        if ship_artifacts and os.path.exists(vcf_path):
            with open(vcf_path, 'rb') as fh:
                cohort.publish_bytes(f'vcf/{sample}', fh.read())
    return gather_manifest(cohort, local, list(assemblies), run_dir=run_dir,
                           log=log, keep_going=keep_going,
                           ship_artifacts=ship_artifacts)
