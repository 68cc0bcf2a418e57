"""Model definitions: building blocks and the Tacotron graph."""
