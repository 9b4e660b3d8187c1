"""ntedit_tpu_torch — the polish engine of ntedit_tpu in PyTorch, with its
device pass as a CUDA kernel written for the NVIDIA H100.

A port of the JAX package ``ntedit_tpu``, which stays in the repository as
the reference: on the same inputs the two give the same output bytes.
The port imports neither JAX nor anything of ``ntedit_tpu``; it keeps its
own copy of the host code it needs.  Entry point:
``python -m ntedit_tpu_torch engine -r <filter> -f <draft> -b <prefix>``.
"""

__version__ = "0.1.0"
