"""Caption metrics: BLEU, ROUGE-L, CIDEr-D, METEOR, approximate SPICE and
the COCO-style harness (``coco_eval.py``)."""
