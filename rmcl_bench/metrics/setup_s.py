"""setup_s: seconds from the run's start to its window's start (the
interpreter's imports, the card, the inputs, the brick table, the kernel
library built or loaded, a warm frame). Host clock."""


def read(ctx):
    return ctx["setup_s"]
