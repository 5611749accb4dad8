"""Host seconds of the brick table's build (ops/accel.build_accel on the
256^3 volume, to its rows on the card). Host clock."""


def read(ctx):
    return ctx["accel_s"]
