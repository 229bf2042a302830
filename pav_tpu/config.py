"""Layered run configuration.

Precedence (lowest to highest): built-in defaults -> config.json / dict -> CLI
overrides -> per-assembly CONFIG column (reference grammar:
pavlib/pipeline.py:404-508, parameter reference CONFIG.md:16-248). The
`reference` parameter cannot be overridden per assembly
(reference: pavlib/pipeline.py:474-475).
"""

import json

# Built-in defaults mirroring the reference's documented parameters (CONFIG.md) plus
# engine-specific knobs for the native aligner.
DEFAULTS = {
    # Input / output
    'reference': None,
    'assembly_table': 'assemblies.tsv',
    'vcf_prefix': '',

    # Aligner (engine-native; reference delegates to minimap2/LRA:
    # rules/align.snakefile:176-221). Presets mirror the reference's choice of
    # minimap2 (default) vs LRA (sensitive contig preset): 'native' and
    # 'native-sensitive' reparameterize the same engine.
    'aligner': 'native',
    'min_mapq': 0,
    'aligner_k': 19,            # minimizer k (asm-preset scale)
    'aligner_w': 10,            # minimizer window
    'aligner_max_occ': 64,      # drop minimizers more frequent than this
    'aligner_chain_max_dist': 50000,
    'aligner_chain_max_gap_diff': 10000,
    'aligner_min_chain_score': 1000,
    'aligner_match': 1,
    'aligner_mismatch': -5,     # asm20-like scoring (-B 5)
    'aligner_gap_open': (5, 56),   # two-piece affine (-O 5,56)
    'aligner_gap_extend': (4, 1),  # (-E 4,1)
    'aligner_band': 256,        # banded-DP half width for gap fill

    # Trimming (reference: rules/align.snakefile:54-97)
    'min_trim_tig_len': 1000,
    'redundant_callset': False,

    # Strict reference parity: disable this engine's documented recall-improving
    # deviations (INV outer-breakpoint gap-edge recovery, INV size-check slack
    # retry, lift gap-interpolation coordinate fix) AND replicate three
    # reference bugs so runs are directly comparable to PAV output
    # (docs/ARCHITECTURE.md "Known deviations"):
    #   1. lgsv left-shift is always 0 (pavlib/align/align.py match_bp
    #      compares char CIGAR ops against int codes; pinned by
    #      test_lgsv_driver_parity);
    #   2. the insdel flag merge drops its final region
    #      (call_inv.snakefile:558-594 never flushes after the loop);
    #   3. cluster flagging uses cluster_win as the minimum span
    #      (call_inv.snakefile:619 typo: cluster_win_min = params.cluster_win).
    'strict_parity': False,

    # CIGAR calling
    'cigar_batch_count': 10,

    # Inversion calling (reference: CONFIG.md inv_* family)
    'inv_k_size': 31,
    'inv_region_limit': 1200000,
    'inv_min_expand_count': 1,
    'inv_init_expand': 4000,
    'inv_expand_factor': 1.5,
    'inv_min_kmers': 2000,
    'inv_min_inv_kmer_run': 100,
    'inv_min_qry_ref_prop': 0.6,
    'inv_min_state_count': 20,
    'inv_density_smooth_factor': 1.0,
    'inv_sig_merge_flank': 500,
    'inv_sig_batch_count': 60,
    'inv_sig_filter': 'svindel',
    'inv_sig_insdel_cluster_flank': 2,
    'inv_sig_insdel_merge_flank': 2000,
    'inv_sig_cluster_svlen_min': 4,
    'inv_sig_cluster_win': 200,
    'inv_sig_cluster_win_min': 500,
    'inv_sig_cluster_snv_min': 20,
    'inv_sig_cluster_indel_min': 10,
    'inv_min': None,
    'inv_max': None,
    'inv_inner': 'filter_core',

    # Large SV calling (reference: pavlib/lgsv.py:19-28)
    'lg_batch_count': 10,
    'lg_max_qry_dist_prop': 1.0,
    'lg_max_ref_dist_prop': 3.0,

    # Merging (reference: pavlib/constants.py:37-45)
    'merge_batch_count': 20,

    # Callable regions
    'callable_flank': 500,

    # Engine / device
    'device_batch': 512,
}


class Config(dict):
    """A dict with attribute access and typed getters."""

    def __getattr__(self, key):
        try:
            return self[key]
        except KeyError as ex:
            raise AttributeError(key) from ex

    def get_bool(self, key):
        from .util import as_bool
        return as_bool(self.get(key, False))

    def get_int(self, key, default=None):
        val = self.get(key, default)
        return None if val is None else int(val)

    def get_float(self, key, default=None):
        val = self.get(key, default)
        return None if val is None else float(val)


def load_config(config=None, config_json=None, overrides=None):
    """Build a Config from defaults, an optional dict or JSON file, and overrides."""
    merged = dict(DEFAULTS)
    if config_json is not None:
        with open(config_json) as fh:
            merged.update(json.load(fh))
    if config:
        merged.update(config)
    if overrides:
        merged.update(overrides)
    return Config(merged)


def parse_config_override_string(config_string):
    """Parse the per-assembly CONFIG column: "key1=val1;key2=val2"
    (reference: pavlib/pipeline.py:404-452)."""
    out = {}
    if config_string is None or (isinstance(config_string, float)) or not str(config_string).strip():
        return out
    for tok in str(config_string).split(';'):
        tok = tok.strip()
        if not tok:
            continue
        if '=' not in tok:
            raise ValueError(f'Missing "=" in CONFIG token: {tok}')
        key, val = (part.strip() for part in tok.split('=', 1))
        if not key or not val:
            raise ValueError(f'Empty key or value in CONFIG token: {tok}')
        out[key] = val
    return out


def override_config(config, override):
    """Apply per-assembly overrides; `reference` may not be overridden
    (reference: pavlib/pipeline.py:455-480)."""
    if not override:
        return config
    merged = Config(config)
    for key, val in override.items():
        if key == 'reference':
            raise ValueError('The reference configuration parameter cannot be defined per sample.')
        merged[key] = val
    return merged
