"""Plain references of the benchmark's configurations.

Written from the published descriptions (RON: Kong et al., CVPR 2017,
`ron_vgg_320.py`; SSD: Liu et al., ECCV 2016, `ssd_vgg_300.py`) in plain
PyTorch and NumPy. Nothing here imports the program under test, JAX or the
JAX package: the reference takes the inputs and weights that the benchmark
makes and works out everything else again (anchors, decoding, selection,
suppression).
"""
