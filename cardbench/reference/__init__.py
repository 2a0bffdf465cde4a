"""The benchmark's plain reference: a frozen copy, in plain PyTorch, of what
the cells run (the port's model, criterion, mapper and optimizer), each CUDA
kernel replaced by its plain version. It imports nothing of the program."""
