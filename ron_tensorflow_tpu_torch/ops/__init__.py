"""Box geometry, decoding, selection, top-k and NMS on torch tensors."""
