"""Command-line tools of the port: the learning checks, the training
supervisor, the synthetic dataset, timing tools and the perf probes for
the card (on `perf_common`'s one timer), the leak probe and the Caffe
layer lister."""
