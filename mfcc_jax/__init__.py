"""mfcc_jax -- streaming MFCC front-end framework in JAX.

A ground-up JAX/XLA re-design of the capabilities of lambdaconcept/mfcc (an
FPGA fixed-point MFCC core + host software), run on a GPU:

  * float pipeline (the notebooks' executable spec) as fused matmuls;
  * bit-exact fixed-point pipeline (the RTL's integer arithmetic);
  * stateful multi-stream chunked streaming with reset protocol;
  * data- and sequence-parallel scaling over device meshes;
  * host I/O: wav decode, framed transport protocol (magic 0xa55a,
    reset word 0x80000000), batch CLI, golden generation, visualization.
"""

from .config import MFCCConfig, DEFAULT_CONFIG, MIC_CONFIG, RESET_WORD, MAGIC_WORD
from .pipeline import MFCC

__version__ = "0.1.0"

__all__ = [
    "MFCC", "MFCCConfig", "DEFAULT_CONFIG", "MIC_CONFIG",
    "RESET_WORD", "MAGIC_WORD", "__version__",
]
