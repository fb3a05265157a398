"""Training side of the port: the objective, TF1 Adam, the learner, the
driver, checkpoints and the train CLI (`python -m
unsupervised_detection_tpu_torch.train`)."""
