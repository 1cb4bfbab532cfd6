"""Training (torch port of `lseg_tpu/train`): the grouped SGD/Adam +
poly optimizer, the train and eval steps, checkpoints and the `fit` loop.
`python -m lseg_tpu_torch.train` is the command line (train.py's)."""
