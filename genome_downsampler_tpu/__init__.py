"""Genomic read-downsampling framework on JAX (device solvers on the GPU).

A from-scratch JAX/XLA/Pallas re-design of the capabilities of
migoox/genome-downsampler: given BAM alignments and a maximum coverage M,
select a minimal (or quality-prioritized) subset of paired-end reads whose
per-base coverage still reaches ``min(input_coverage, M)`` everywhere.

Layer map (mirrors SURVEY.md section 7):

- ``core``     tensorized read model (``ReadBatch`` SoA of fixed-width arrays)
- ``ops``      device ops: coverage scatter/scan, demands, filter masks
- ``solvers``  interval-flow solvers (quasi-MCP push-relabel, exact MCP/QMCP)
- ``parallel`` genome-window sharding over a device mesh + collectives
- ``io``       C++ host BAM/BGZF reader-writer bindings, BED/TSV parsing
- ``cli``      the ``genome-downsampler`` compatible command line
- ``testing``  synthetic read generators and fixtures
- ``utils``    logging, timers, profiling hooks
"""

__version__ = "0.1.0"

from genome_downsampler_tpu.core.readbatch import ReadBatch  # noqa: F401
