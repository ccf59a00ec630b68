"""Preprocessing (eval resize, whitening, the train augmentation), JPEG
decode, VOC annotations and the host-to-card batch pipeline."""
