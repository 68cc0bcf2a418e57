"""Studies that train, serve and evaluate the port end to end:
counterparts of the repo's ``scripts/make_synthetic_corpus.py``,
``convergence_study.py``, ``mulaw_quality.py``, ``serving_load.py``,
``synth_sweep.py``, ``bf16_study.py`` and ``batch_study.py``, one module
each under the same name.  Each runs as
``python -m tacotron_tpu_torch.studies.<name>`` with the script's flags,
on the card (``--device cpu`` for the CPU, except the corpus writer, which
touches no device)."""
