"""The plain reference that decides ``correct``: float32 PyTorch (TF32 off)
or Python, written from the published models and the server's documented
behaviour.  Nothing here imports JAX, the JAX package or the port; the
harness hands it the seeded weights and inputs and the program's outputs,
which it reads only to judge them.
"""
