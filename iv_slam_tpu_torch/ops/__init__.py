"""Image, feature and matching ops: the stereo frontend, projection and BoW
matching, triangulation, the vocabulary-tree descent; ``*_cuda.py`` wrap the
CUDA kernels."""
