"""List the layers and blobs of a .caffemodel, without a caffe installation:
the `convert_caffe_ron.py` parameter lister (ref: convert_caffe_ron.py:42-53),
over the port's own parser (`train/caffe_import.py::parse_caffemodel`).

    python -m ron_tensorflow_tpu_torch.tools.list_caffemodel model.caffemodel

Prints, for each layer that holds blobs, its name, type and blob shapes,
then the number of layers: the lines of the JAX package's
`tools/list_caffemodel.py`. Reads a file on the host; no device.
"""

from __future__ import annotations

import sys
from typing import Dict

from ..train.caffe_import import parse_caffemodel


def layer_lines(path: str) -> list:
    layers = parse_caffemodel(path)
    lines = []
    for name, (ltype, blobs) in layers.items():
        shapes = ", ".join(str(tuple(b.shape)) for b in blobs)
        lines.append(f"{name:40s} {ltype:20s} blobs: {shapes}")
    lines.append(f"{len(layers)} layers with parameters")
    return lines


def main(argv=None) -> Dict:
    """Print the lines; -> {"lines": [...], "layers": count}."""
    (path,) = sys.argv[1:] if argv is None else argv
    lines = layer_lines(path)
    for line in lines:
        print(line)
    return {"lines": lines, "layers": len(lines) - 1}


if __name__ == "__main__":
    main()
    sys.exit(0)
