"""The benchmark's plain reference renderer: plain PyTorch, float32.

A frozen copy of the port's plain version (its options derivation, MC
sampling, camera, raw march, shading, blend and pack; thi-ng/raymarchcl's
renderer.cl and core.clj), kept here so that no later change to the
program can move the yardstick. It imports nothing of the program.

It differs from the program's plain version in one way that changes no
value: it renders *lanes*, each a (frame pose, pixel, pass) triple with its
own eye position, pass time and MC table, so that all the passes of the
pixels under check are marched together instead of pass by pass
(`render.reference_pixels`). It marches without a brick table; the image
is the same with or without one.
"""
