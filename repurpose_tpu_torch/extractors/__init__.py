"""Feature extractors of the port, in PyTorch: the counterparts of
``repurpose_tpu/extractors/``, run on the card in large batches.

- ``clip_vit``: CLIP ViT-B/32 image encoder (visual stream, 512-d a second);
- ``cnn14``: PANNs CNN14 audio embeddings (audio stream, 2048-d a second);
- ``minilm``: MiniLM-L6 sentence encoder (text stream, 384-d a second);
- ``audio_frontend``: STFT and log-mel (CNN14's input), ``fallback_audio``
  the classical-DSP audio features used without a CNN14 checkpoint;
- ``whisper_torch``: Whisper ASR (encoder, KV-cached decoder, greedy and
  beam decoding with the timestamp rules), ``whisper_align`` its word
  aligner over the decoder's cross-attention and root ``csrc/dtw.cc``.

Each module takes an explicit ``device`` and compute dtype; parameters are
float32 and are cast to the compute dtype where they are used, as the JAX
modules' ``dtype=`` does. Each ships a converter from the published
checkpoint's names (HF or PANNs) to its state dict;
``models.convert.extractor_state_dict_from_jax_params`` carries the JAX
modules' params across. No pretrained weights are fetched.
"""
