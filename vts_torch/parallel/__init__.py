"""Several garments and several devices (``vts_tpu/parallel``): the fleet of
per-garment training states (:mod:`.fleet`), the packed layout of G
garments' weights on grouped convs (:mod:`.packing`), device layouts
(:mod:`.mesh`) and the collectives of a data-parallel step (:mod:`.dist`)."""
