"""LLMVoX on PyTorch and CUDA: streaming TTS serving and decoder training on
NVIDIA GPUs.

A port of the ``llmvox_tpu`` JAX package that keeps its module layout and
its parameter layout (channel-last activations, Linear weights
``(Cin, Cout)``, conv kernels ``(K, Cin/groups, Cout)``, decoder layers
stacked along the leading axis of ``params["h"]``), so every function here
has a counterpart under the same path there.  Plain tensor code is
PyTorch; the decode-attention kernel is hand-written CUDA for Hopper
(``csrc/decode_attention.cu``), built at first use.

Subpackages
-----------
- ``utils``    — config, parameter bridge and initialisers, tracing, devices
- ``text``     — ByT5 byte tokenizer, text cleaning
- ``streams``  — text-stream protocol and the scripted stream
- ``ops``      — nn ops, attention (plain and CUDA kernel), ISTFT, kernel build
- ``models``   — the speech-token decoder (streaming decode, training
  forward and loss), the Llama, Whisper, GPT-2 weight import
- ``codec``    — WavTokenizer decode (VQ lookup, ConvNeXt backbone, ISTFT head)
- ``serve``    — TTS engine, dual-replica scheduler, HTTP server and CLI
- ``train``    — decoder training: data, optimizer, checkpoints, trainer, CLI
- ``tools``    — checkpoint converters, graph warmup
"""

__version__ = "0.1.0"
