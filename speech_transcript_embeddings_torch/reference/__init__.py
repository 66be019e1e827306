"""Plain references of the port's models: plain ``torch``, no kernel or
module of the program."""
