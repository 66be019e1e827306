"""Training path of the port: losses, optimizer, train/eval steps, loop."""
