"""Eval preprocessing: TF1 legacy bilinear resize and VGG whitening."""
