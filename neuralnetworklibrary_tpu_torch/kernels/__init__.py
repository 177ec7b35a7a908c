"""Build, load and bind the port's native libraries: the CUDA kernels in
``csrc/`` and the host C++ helpers in ``native/``."""
