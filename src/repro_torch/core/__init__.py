"""Plain PyTorch references shared by the model and the tests."""
