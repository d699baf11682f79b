# Runtime image for the genome downsampler.
# Parity with the reference's Dockerfile (/root/reference/Dockerfile), which
# ships the compiled binary on ubuntu; here the native pieces (io/csrc) are
# compiled at build time. The image installs CPU-only JAX; on an NVIDIA
# host install "jax[cuda12]" instead to run the device solvers on the GPU.

FROM python:3.12-slim

RUN apt-get update \
    && apt-get install -y --no-install-recommends g++ zlib1g-dev \
    && rm -rf /var/lib/apt/lists/*

WORKDIR /opt/genome-downsampler
COPY pyproject.toml README.md ./
COPY genome_downsampler_tpu ./genome_downsampler_tpu

# GPU hosts: pip install "jax[cuda12]" instead (kept CPU-only for portability)
RUN pip install --no-cache-dir jax numpy scipy && pip install --no-cache-dir .

# pre-build the native library so first run needs no compiler round trip
RUN python -c "from genome_downsampler_tpu.io.build import build_bamio; build_bamio(force=True)"

ENTRYPOINT ["genome-downsampler"]
