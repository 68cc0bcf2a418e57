"""PyTorch / CUDA port of the multi-speaker Tacotron TTS system, for one
NVIDIA H100.

The JAX package beside it is the reference; this package imports none of it
(nor JAX) and keeps its own copies of what it needs.  Ported: the serving
path (text frontend -> Tacotron greedy decode -> attention trim ->
Griffin-Lim vocoder -> int16 waveform, ``synth/``), with the JAX package's
four TPU kernels rewritten as CUDA C++ kernels for ``sm_90a`` (``csrc/``),
and the training path (feeders, train step, optimizer, checkpoints and the
driver, ``train/``, ``data/``).  Entry points run on the card unless the
caller asks for the CPU.
"""

__version__ = "0.1.0"

from .config import (AudioConfig, Config, DataConfig, MeshConfig,  # noqa: E402
                     ModelConfig, TrainConfig, load_config, save_config)

__all__ = [
    "AudioConfig", "Config", "DataConfig", "MeshConfig", "ModelConfig",
    "TrainConfig", "load_config", "save_config", "__version__",
]
