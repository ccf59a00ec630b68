"""The port's Caffe layer lister (`ron_tensorflow_tpu_torch/tools/
list_caffemodel.py`) against the JAX package's (repo-root
`tools/list_caffemodel.py`, loaded by path): on caffemodels written as
`tests/test_torch_caffe_import.py` writes them, in every blob and layer
encoding, the printed lines are equal."""

import importlib.util
from pathlib import Path

import pytest

from ron_tensorflow_tpu_torch.tools import list_caffemodel
from test_torch_caffe_import import VGG, caffemodel

JAX_TOOL = Path(__file__).resolve().parent.parent / "tools" / "list_caffemodel.py"


def jax_lister():
    spec = importlib.util.spec_from_file_location("jax_list_caffemodel", JAX_TOOL)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("shape", ["packed", "unpacked", "legacy"])
@pytest.mark.parametrize("v1", [False, True])
def test_lines_equal_the_jax_tools(shape, v1, tmp_path, capsys):
    path, blobs = caffemodel(tmp_path, shape, v1)
    assert jax_lister().main(path) == 0
    theirs = capsys.readouterr().out.splitlines()
    ours = list_caffemodel.main([path])
    printed = capsys.readouterr().out.splitlines()
    assert printed == theirs == ours["lines"]
    assert ours["layers"] == len(blobs) == len(VGG) + 2
    assert theirs[-1] == f"{len(blobs)} layers with parameters"
