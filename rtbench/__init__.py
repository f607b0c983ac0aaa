"""The benchmark of the PyTorch and CUDA port (``i3rc_tpu_torch``): see run.py."""
