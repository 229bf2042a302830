# Container packaging for pav_tpu (reference analog: /root/reference/Dockerfile:1-81
# + files/run_scripts/runlocal.sh — Snakemake + native deps baked into an image).
# Here the engine is one Python package; its native pieces build themselves
# from the bundled sources at first use (pav_tpu/native.py with g++; on a GPU
# host, pav_tpu/ops/wave_gpu.py with the CUDA toolkit's nvcc).
#
# Build:  docker build -t pav-tpu .
# Run:    docker run --rm -v $PWD:/work pav-tpu \
#             --ref /work/ref.fa --assemblies /work/assemblies.tsv \
#             --run-dir /work/pav_run
FROM python:3.12-slim

RUN apt-get update && apt-get install -y --no-install-recommends g++ \
    && rm -rf /var/lib/apt/lists/*

# CPU JAX by default. For an NVIDIA GPU build from a CUDA base image with the
# toolkit (nvcc) and install 'jax[cuda12]' instead.
RUN pip install --no-cache-dir jax numpy pandas matplotlib

WORKDIR /opt/pav-tpu
COPY pyproject.toml README.md ./
COPY pav_tpu ./pav_tpu
COPY native ./native
RUN pip install --no-cache-dir --no-build-isolation --no-deps -e .

ENTRYPOINT ["pav-tpu"]
CMD ["--help"]
