"""PostProcess-dataset generation (counterpart of the JAX package's
scripts/gen_pp_data.py; reference scripts/pp_gen.py).

Runs the pipeline through blending (refinement cut off: the reference's
RaiseDownsample exception hack, pp_gen.py:31-50, is the explicit
train/datagen.generate_pp_sample here) and writes one .npz row per triple:
source, target, target_mask, HT_E and the full-res source_full (the
discriminator's real images). Each row runs the dilate/erode kernel twice
on a CUDA device (align_images' soft masks and the blend masks).

    python -m hairfastgan_torch.scripts.gen_pp_data --input_dir imgs \
        --n_random 1000 --out_dir pp_rows
    python -m hairfastgan_torch.scripts.gen_pp_data --micro --device cpu \
        --input_dir imgs --n_random 4 --out_dir pp_rows

Input: --file_path with lines "face shape color" (paths relative to
--input_dir), or --n_random random triples drawn from --input_dir. The zoo
comes from --zoo_dir when it exists (zoo.load_zoo), else random weights.
--device defaults to cuda and raises without a GPU. --tiny and --micro
(not in the JAX script) run the CLI's 128^2 random zoos, whose rows
train_pp --tiny / --micro reads.
"""

from __future__ import annotations

from hairfastgan_torch.scripts.gen_blending_data import parser, write_rows


def main(argv=None):
    from hairfastgan_torch.train.datagen import generate_pp_sample

    write_rows(parser().parse_args(argv), generate_pp_sample)


if __name__ == "__main__":
    main()
