"""Studies that train and evaluate the port end to end: counterparts of
the repo's ``scripts/make_synthetic_corpus.py``,
``scripts/convergence_study.py`` and ``scripts/mulaw_quality.py``, one
module each under the same name.  Each runs as
``python -m tacotron_tpu_torch.studies.<name>`` (on the card; the study
and the mu-law check take ``--device cpu``)."""
