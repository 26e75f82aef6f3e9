"""DreamBooth + LoRA fine-tuning CLI of the PyTorch port
(stable_diffusion_tpu_torch): ``train_lora_dreambooth.py``'s flags and
training behaviour, on the port's train step.

    python train_lora_dreambooth_torch.py --model_path DIR_OR_FILE \\
        --tokenizer_dir DIR --data_dir DATA --img_size 512 --batch_size 2 \\
        --max_train_steps 1000 --use_ema [--device cuda]

* ``DATA/instance_data`` and ``DATA/class_prior_data`` hold the images and
  each its ``label.txt``; a batch is ``batch_size`` instance and
  ``batch_size`` prior images (the DreamBooth loss, prior weight 1.0).
* LoRA of rank 128 (alpha 128) on the attention projections, EMA with
  warm-up, gradient accumulation, gradient checkpointing, an eval pass and a
  checkpoint (``checkpoint_dir/epoch-N.ckpt``) each epoch, ``--pretrained_path``
  resume; ``max_train_steps`` counts optimizer updates, and epochs =
  ceil(max_train_steps / ceil(len(loader) / accumulation)).
* ``--cache_latents`` (the default) encodes every instance and prior image
  once with the frozen VAE (its mean and std, ``micro_batch`` images at a
  time) and the two prompts once with the frozen text tower (not under
  ``--train_text_encoder``), and trains from that cache: the transforms are
  resize only, so this is exact.  ``--no-cache_latents`` encodes every step.
* Every random draw (the LoRA's A matrices, then each batch's timesteps,
  noise and VAE noise, eval batches included) comes from one
  ``torch.Generator`` seeded with ``--seed`` on the device, in the same
  order with and without the cache, so the two runs see the same noise.

``--device cuda`` (the default) runs the hand-written kernels in bf16;
``--device cpu`` runs the plain versions in f32.  ``cuda`` without a card
raises.  ``--model_path`` is a diffusers directory or a single LDM file
(``--sd_version`` picks its configs); a ``.ckpt`` is unpickled, which runs
code from the file: use trusted files only.  ``--use_flash_attn`` and
``--use_lora`` are accepted for parity (the kernels and the LoRA always run);
``--profile_dir`` writes a ``torch.profiler`` trace of the training loop.

Across ranks (JAX runs every device in one process; here one process a
rank, started by PyTorch's launcher, which sets RANK, WORLD_SIZE,
MASTER_ADDR and MASTER_PORT)::

    python -m torch.distributed.run --nproc_per_node 2 \
        train_lora_dreambooth_torch.py --mesh_model_axis 2 ...

The ranks form a ("data", "model") mesh (parallel/mesh.py): "model" is
``--mesh_model_axis`` (tensor parallelism: the UNet's and text tower's
transformer linears split), "data" is JAX's gcd(2 * batch_size, world /
model) (the batch's lanes split).  A world the mesh does not fill (JAX
leaves those devices idle) is refused before anything loads.  Every rank
loads the whole batch and draws the whole batch's noise from the one
generator, the LoRA tree and the optimizer state stay whole and the same
on every rank, and only rank 0 writes checkpoints, logs and progress
lines.  Without the launcher's variables the run is a world of one.
"""

import argparse
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np


def build_parser():
    p = argparse.ArgumentParser(description="Training Arguments")
    p.add_argument("--device", default="cuda", type=str,
                   help="cuda (the kernels, bfloat16) or cpu (the plain versions, float32)")
    p.add_argument("--model_path", default="./weights/model/v1-5-pruned-emaonly.ckpt",
                   help="Model path (.ckpt or diffusers dir)")
    p.add_argument("--tokenizer_dir", default="./weights/tokenizer/", help="Tokenizer dir")
    p.add_argument("--data_dir", default="data/sprites", type=str, help="Data directory")
    p.add_argument("--img_size", default=32, type=int, help="Image size")
    p.add_argument("--batch_size", default=32, type=int, help="Batch size (per DreamBooth half)")
    p.add_argument("--use_ema", action=argparse.BooleanOptionalAction)
    p.add_argument("--save_dir", default="./checkpoints/", help="Directory to save model")
    p.add_argument("--checkpoint_dir", default="./checkpoints/", help="Directory to save checkpoint")
    p.add_argument("--pretrained_path", default=None, help="Resume checkpoint path")
    p.add_argument("--lr", default=1e-6, type=float, help="Learning rate")
    p.add_argument("--max_train_steps", default=1000, type=int)
    p.add_argument("--use_lora", action=argparse.BooleanOptionalAction)
    p.add_argument("--gradient_accumulation_steps", default=1, type=int)
    p.add_argument("--gradient_checkpointing", action=argparse.BooleanOptionalAction)
    p.add_argument("--use_flash_attn", action=argparse.BooleanOptionalAction)
    p.add_argument("--train_text_encoder", action=argparse.BooleanOptionalAction)
    p.add_argument("--use_8bit_adam", action=argparse.BooleanOptionalAction)
    p.add_argument("--seed", default=None, type=int)
    p.add_argument("--num_class_prior_images", default=None, type=int)
    p.add_argument("--sd_version", default="1.5", type=str)
    p.add_argument("--mesh_model_axis", default=1, type=int,
                   help="Tensor-parallel width (the mesh's 'model' axis) over the ranks that "
                        "python -m torch.distributed.run starts")
    p.add_argument("--log_dir", default="runs", type=str, help="TensorBoard log dir")
    p.add_argument("--lr_scheduler", default="constant",
                   choices=["constant", "constant_with_warmup", "cosine"],
                   help="LR schedule over the optimizer-update horizon")
    p.add_argument("--lr_warmup_steps", default=0, type=int)
    p.add_argument("--profile_dir", default="", type=str,
                   help="Write a torch.profiler trace (Chrome JSON) of the training loop here")
    p.add_argument("--cache_latents", action=argparse.BooleanOptionalAction, default=True,
                   help="Encode the instance and prior images (the frozen VAE's mean and std) "
                        "and the prompts (the frozen text tower) once and train from the cache; "
                        "exact, since the transforms are resize only. --no-cache_latents "
                        "encodes every step.")
    return p


def mesh_shape(args):
    """(world, data, model): the launcher's WORLD_SIZE (1 without it),
    ``--mesh_model_axis`` and JAX's data axis gcd(2 * batch_size, world /
    model).  A world the axis does not divide, or one the mesh leaves ranks
    of, is refused."""
    world, model = int(os.environ.get("WORLD_SIZE", "1")), args.mesh_model_axis
    if model < 1 or world % model:
        raise ValueError(f"--mesh_model_axis {model} does not divide a world of {world} rank(s): "
                         "start them with python -m torch.distributed.run --nproc_per_node N")
    data = math.gcd(2 * args.batch_size, world // model)
    if data * model != world:
        raise ValueError(f"--mesh_model_axis {model} with --batch_size {args.batch_size} makes a "
                         f"({data}, {model}) mesh, which leaves {world - data * model} of {world} "
                         f"ranks idle: start {data * model}")
    return world, data, model


def join_mesh(args):
    """This rank's ``parallel.mesh.Mesh`` under the launcher's variables
    (its process group joined by ``env://`` unless one is already up), or
    None in a world of one without them."""
    if "WORLD_SIZE" not in os.environ:
        return None
    import torch.distributed as dist

    from stable_diffusion_tpu_torch.parallel import mesh as pmesh

    world, data, model = mesh_shape(args)
    if not dist.is_initialized():
        pmesh.init_distributed(int(os.environ["RANK"]), world, "env://", device=args.device)
    return pmesh.make_mesh(data, model)


def check_device(args):
    """(device, dtype, impl) of ``--device``, refused before anything loads
    (with a world the mesh cannot hold): a missing card is not replaced by
    the CPU."""
    import torch

    mesh_shape(args)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda, but torch.cuda.is_available() is false; "
                               "pass --device cpu to run the plain versions")
        return device, torch.bfloat16, "cuda"
    if device.type != "cpu":
        raise ValueError(f"--device must be cuda or cpu, got {args.device!r}")
    return device, torch.float32, "torch"


def load_base(args):
    """The frozen models of ``--model_path`` on ``--device`` (a diffusers
    directory or an LDM file; the device refused before anything loads) and
    the tokenizer of ``--tokenizer_dir``."""
    from stable_diffusion_tpu_torch.pipeline import StableDiffusion
    from stable_diffusion_tpu_torch.tokenizer import load_tokenizer

    device, dtype, impl = check_device(args)
    pipe = StableDiffusion.from_pretrained(args.model_path, sd_version=args.sd_version,
                                           dtype=dtype, impl=impl, device=device)
    for m in (pipe.unet, pipe.text_encoder, pipe.vae):
        m.requires_grad_(False)
    base = {"unet": pipe.unet, "text_encoder": pipe.text_encoder, "vae": pipe.vae}
    return base, load_tokenizer(args.tokenizer_dir)


class _Lazy:
    """Images by index, loaded when asked: the moments pass streams
    ``micro_batch`` of them at a time, so a large prior set never sits on
    the host as one float32 stack."""

    def __init__(self, get, n):
        self._get, self._n = get, n

    def __len__(self):
        return self._n

    def __getitem__(self, i):
        return self._get(i)


def train(args, base, tokenizer, mesh=None):
    """The training loop on ``base`` ({"unet", "text_encoder", "vae"}, frozen,
    on ``--device``; sharded here on ``mesh``, after the LoRA tree is drawn
    from the whole models); returns the final train state.  The schedule is
    SD1.5's (epsilon), whatever the model's scheduler config, as the JAX
    trainer's is."""
    import torch

    from stable_diffusion_tpu_torch.parallel import mesh as pmesh

    from inference_torch import profile
    from stable_diffusion_tpu_torch import training as T
    from stable_diffusion_tpu_torch.schedulers import schedule as S
    from stable_diffusion_tpu_torch.utils import checkpoint as ckpt
    from stable_diffusion_tpu_torch.utils import datasets

    device, dtype, impl = check_device(args)
    lead = mesh is None or torch.distributed.get_rank() == 0  # writes and prints
    say = print if lead else (lambda *a, **k: None)
    writer = None
    if lead:
        try:
            from torch.utils.tensorboard import SummaryWriter
            writer = SummaryWriter(args.log_dir)
        except ImportError:  # tensorboard is optional
            pass

    train_cfg = T.TrainConfig(
        learning_rate=args.lr, rank=128, alpha=128.0,
        grad_accum_steps=args.gradient_accumulation_steps, use_ema=bool(args.use_ema),
        gradient_checkpointing=bool(args.gradient_checkpointing),
        train_text_encoder=bool(args.train_text_encoder),
        lora_targets=("q_proj", "k_proj", "v_proj", "out_proj"),
        lr_schedule=args.lr_scheduler, lr_warmup_steps=args.lr_warmup_steps,
        lr_total_steps=args.max_train_steps, use_8bit_adam=bool(args.use_8bit_adam))
    gen = torch.Generator(device=device).manual_seed(args.seed or 0)
    state = T.init_train_state(gen, base, train_cfg)
    start_epoch = 0
    if args.pretrained_path:
        restored = ckpt.load_train_checkpoint(args.pretrained_path, device=device)
        state, start_epoch = restored["state"], int(restored["epoch"]) + 1

    if mesh is not None:
        for m in (base["unet"], base["text_encoder"]):
            pmesh.shard_module_(m, mesh)
    schedule = S.make_schedule()
    step_fn = T.make_train_step(base, schedule=schedule, train_cfg=train_cfg, impl=impl, mesh=mesh)
    eval_fn = T.make_eval_step(base, schedule=schedule, train_cfg=train_cfg, impl=impl, mesh=mesh)
    train_dl, test_dl = datasets.create_dataloaders(
        tokenizer, instance_data_dir=os.path.join(args.data_dir, "instance_data"),
        class_data_dir=os.path.join(args.data_dir, "class_prior_data"), train_test_split=1.0,
        batch_size=args.batch_size, num_workers=0, img_size=(args.img_size, args.img_size),
        num_class_prior_images=args.num_class_prior_images)
    updates_per_epoch = math.ceil(len(train_dl) / args.gradient_accumulation_steps)
    epochs = math.ceil(args.max_train_steps / max(updates_per_epoch, 1))
    factor = 2 ** (len(base["vae"].cfg.ch_mult) - 1)  # the VAE's downsampling
    on_device = lambda a, dt=dtype: torch.as_tensor(a, device=device, dtype=dt)  # noqa: E731

    def noise_for(lat_shape):
        t, noise, vnoise = T.sample_noise_for_latents(gen, lat_shape, device=device, dtype=dtype)
        return {"t": t, "noise": noise, "vae_noise": vnoise}

    if args.cache_latents:
        ds = train_dl.dataset
        t_pre = time.time()
        vae = base["vae"]
        inst_mean, inst_std = T.precompute_latent_moments(
            vae, _Lazy(ds.instance_pixels, ds.num_instance), impl=impl)
        cls_mean, cls_std = T.precompute_latent_moments(
            vae, _Lazy(ds.class_pixels, ds.num_class), impl=impl)
        ids_pair = tokenizer.pad(
            {"input_ids": [ds._tokenize(ds.instance_prompt), ds._tokenize(ds.class_prompt)]},
            padding="max_length", max_length=77, return_tensors="np")["input_ids"]
        ids_pair = torch.as_tensor(ids_pair, dtype=torch.long, device=device)
        emb_pair = None
        if not train_cfg.train_text_encoder:
            emb_pair = T.precompute_text_embedding(base["text_encoder"], ids_pair, impl=impl)
        say(f"cached frozen encoders: {ds.num_instance}+{ds.num_class} images "
            f"({time.time() - t_pre:.1f}s)", flush=True)

        def train_batches(dl):
            for idx in dl.iter_indices():
                ii = [i % ds.num_instance for i in idx]
                ci = [i % ds.num_class for i in idx]
                mean = np.concatenate([inst_mean[ii], cls_mean[ci]])
                pair = torch.tensor([0] * len(idx) + [1] * len(idx), device=device)
                batch = {"latent_mean": on_device(mean),
                         "latent_std": on_device(np.concatenate([inst_std[ii], cls_std[ci]])),
                         **noise_for(mean.shape)}
                if emb_pair is None:  # text LoRA training: ids, not embeddings
                    batch["input_ids"] = ids_pair[pair]
                else:
                    batch["text_emb"] = emb_pair[pair]
                yield batch
    else:
        def train_batches(dl):
            for b in dl:
                imgs = b["pixel_values"]
                n, h, w, _ = imgs.shape
                yield {"images": on_device(imgs), "input_ids": on_device(b["input_ids"], torch.long),
                       **noise_for((n, h // factor, w // factor, 4))}

    micro_steps = 0
    accum = max(args.gradient_accumulation_steps, 1)
    with profile(args.profile_dir, device.type):
        for epoch in range(start_epoch, start_epoch + epochs):
            losses = []
            t0 = time.time()
            for batch in train_batches(train_dl):
                state, metrics = step_fn(state, batch)
                losses.append(float(metrics["loss"]))
                micro_steps += 1
                if micro_steps // accum >= args.max_train_steps:
                    break
            mean_loss = float(np.mean(losses)) if losses else float("nan")
            test_losses = [float(eval_fn(state, b)) for b in train_batches(test_dl)]
            test_loss = float(np.mean(test_losses)) if test_losses else float("nan")
            say(f"epoch {epoch}: loss={mean_loss:.4f} test_loss={test_loss:.4f} "
                f"({time.time() - t0:.1f}s)", flush=True)
            if writer:
                writer.add_scalars("Loss", {"train": mean_loss, "test": test_loss}, epoch)
            if lead:
                os.makedirs(args.checkpoint_dir, exist_ok=True)
                path = ckpt.save_train_checkpoint(
                    os.path.join(args.checkpoint_dir, f"epoch-{epoch}"),
                    {"epoch": epoch, "state": state})
                say(f"saved checkpoint: {path}", flush=True)
            if micro_steps // accum >= args.max_train_steps:
                break
    if writer:
        writer.close()
    return state


def main(argv=None):
    """Parse ``argv``, refuse what cannot run, join the mesh when launched
    across ranks, load and train; the final train state.  A process group
    this call joined is left before it returns."""
    import torch.distributed as dist

    args = build_parser().parse_args(argv)
    check_device(args)
    joined = not dist.is_initialized()
    mesh = join_mesh(args)
    try:
        base, tokenizer = load_base(args)
        state = train(args, base, tokenizer, mesh)
        if mesh is not None:
            dist.barrier()  # rank 0's checkpoint is written before any rank returns
        return state
    finally:
        if mesh is not None and joined:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
