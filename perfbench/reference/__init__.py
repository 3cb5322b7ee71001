"""Plain PyTorch references of the configurations, independent of the program."""
