"""FCN training: losses, the SGD recipe and train step, the dataset and the trainer."""
