"""The plain reference that decides `correct`: MonoRTM in plain PyTorch,
independent of the program."""
