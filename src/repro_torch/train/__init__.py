"""Training stack of the port: optimizers (:mod:`.optim`), checkpoints in
the reference's on-disk format (:mod:`.checkpoint`), the step factory and
the resumable loop (:mod:`.trainer`), over trees of tensors (:mod:`.tree`).
"""
