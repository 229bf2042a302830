"""pav_tpu: GPU-accelerated assembly-to-reference variant-calling engine.

A from-scratch JAX/XLA + CUDA framework with the capabilities of PAV
(EichlerLab/pav v2.4.6): contig-vs-reference alignment, alignment trimming,
SNV/indel/SV/inversion calling, haplotype merging, and VCF emission — as one
in-memory engine over device-resident sequence rather than a file-passing
Snakemake DAG. See SURVEY.md for the structural map of the reference.
"""

from .constants import get_version_string

__version__ = get_version_string()
