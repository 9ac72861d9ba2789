"""Caption metrics the SCST reward reads (``bleu.py``)."""
