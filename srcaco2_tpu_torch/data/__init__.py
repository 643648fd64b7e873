"""Data: fold files, image IO, the staged datasets, the in-step pipeline,
sampling, the synthetic dataset, the dataset builders from raw sessions
and the CSR-CNN noise augmenter."""
