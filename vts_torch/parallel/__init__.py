"""Many garments on one card (``vts_tpu/parallel``): the fleet of per-garment
training states (:mod:`.fleet`) and the packed layout of G garments' weights
on grouped convs (:mod:`.packing`)."""
