"""Models of the port: the decoder-only LM (:mod:`.transformer`, MoE layers
in :mod:`.moe`) on the shared layers (:mod:`.layers`), BERT4Rec
(:mod:`.bert4rec`) and the GNN zoo (:mod:`.gnn`)."""
