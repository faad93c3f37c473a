"""The plain reference: M2Trans, MedCLIP, the semantic loss and the train
step in plain PyTorch (NCHW, f32, TF32 off), from reference-format state
dicts. It imports nothing of the port and takes nothing the port made; the
comparison that decides ``correct`` lives in :mod:`.compare`."""
