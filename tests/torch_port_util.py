"""Shared helper of the tests/test_torch_*.py files: one small BERT in the
JAX package and the same BERT in the port, with the same parameters."""
import numpy as onp

SMALL_BERT = dict(vocab_size=100, num_layers=2, units=64, hidden_size=128,
                  num_heads=4, max_length=64, dropout=0.1)


def bert_pair(seed=0):
    """(jax_net, port_net, params): the JAX net initialized from ``seed``,
    its parameters as numpy, and the port net (CPU, f32) loaded from
    them through ``load_jax_params``."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo.bert import get_bert as jax_get_bert
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.bert import get_bert

    mx.random.seed(seed)
    jnet = jax_get_bert("bert_12_768_12", **SMALL_BERT)
    jnet.initialize(mx.init.Normal(0.05))
    params = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    tnet = get_bert("bert_12_768_12", device="cpu", **SMALL_BERT)
    load_jax_params(tnet, params)
    return jnet, tnet, params


def jax_forward(jnet, tokens, valid_length, token_types=None,
                masked_positions=None):
    import mxnet_tpu as mx
    arr = (lambda a: None if a is None else mx.np.array(a))
    out = jnet(arr(tokens), arr(token_types), arr(valid_length),
               arr(masked_positions))
    return [o.asnumpy() for o in out]


def inputs(seed, B, T, valid):
    rng = onp.random.RandomState(seed)
    tokens = rng.randint(0, SMALL_BERT["vocab_size"], (B, T)).astype("int32")
    types = rng.randint(0, 2, (B, T)).astype("int32")
    return tokens, types, onp.asarray(valid, "int32")


TINY_GPT = dict(vocab_size=97, num_layers=2, units=32, hidden_size=48,
                num_heads=4, max_length=64, dropout=0.0)


def gpt_pair(seed=0, sigma=1.0, **cfg):
    """(jax_net, port_net, params): a small JAX GPT initialized from
    ``seed`` with ``Normal(sigma)`` (a strong init keeps greedy streams
    from collapsing to one token), its parameters as numpy, and the port
    GPT (CPU, f32) loaded from them through ``load_jax_params``."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo.gpt import GPTModel as JGPT
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.gpt import GPTModel

    cfg = dict(TINY_GPT, **cfg)
    mx.random.seed(seed)
    jnet = JGPT(**cfg)
    jnet.initialize(mx.init.Normal(sigma))
    jnet(mx.np.zeros((1, 4), dtype="int32"))
    params = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    tnet = GPTModel(**cfg)
    load_jax_params(tnet, params)
    tnet.eval()
    return jnet, tnet, params


TINY_TRANSFORMER = dict(src_vocab_size=61, num_encoder_layers=2,
                        num_decoder_layers=2, units=32, hidden_size=128,
                        num_heads=4, max_length=48, dropout=0.0)


def strong_transformer_params(params, seed):
    """numpy weights in the shapes of ``params``, at a scale where greedy
    streams vary: matrices N(0, 1/fan_in), embeddings N(0, 0.25),
    positions N(0, 1) (the position steers each step), biases N(0, 0.02),
    LayerNorm gamma 1 + N(0, 0.02); a tied embedding stays tied."""
    rng = onp.random.RandomState(seed)
    out = {}
    for k, v in params.items():
        z = rng.standard_normal(v.shape).astype("float32")
        if k.endswith("embed.weight"):
            out[k] = z * 0.5
        elif k.endswith("_pos"):
            out[k] = z
        elif k.endswith(".weight"):
            out[k] = z / onp.float32(onp.sqrt(v.shape[1]))
        elif k.endswith("gamma"):
            out[k] = 1.0 + 0.02 * z
        else:
            out[k] = 0.02 * z
    if params["src_embed.weight"] is params["tgt_embed.weight"] or (
            params["src_embed.weight"].shape
            == params["tgt_embed.weight"].shape and onp.array_equal(
                params["src_embed.weight"], params["tgt_embed.weight"])):
        out["tgt_embed.weight"] = out["src_embed.weight"]
    return out


def transformer_pair(seed=0, strong=False, **cfg):
    """(jax_net, port_net, params): a small JAX encoder-decoder Transformer
    initialized from ``seed`` (its own initializers, or with ``strong``
    :func:`strong_transformer_params`), its parameters as numpy, and the
    port's (CPU, f32) loaded from them through ``load_jax_params``."""
    import mxnet_tpu as mx
    from mxnet_tpu.gluon.model_zoo.transformer import TransformerModel as JT
    from mxnet_tpu_torch.convert import load_jax_params
    from mxnet_tpu_torch.gluon.model_zoo.transformer import TransformerModel

    cfg = dict(TINY_TRANSFORMER, **cfg)
    mx.random.seed(seed)
    jnet = JT(**cfg)
    jnet.initialize()
    jnet(mx.np.zeros((1, 4), dtype="int32"),
         mx.np.zeros((1, 3), dtype="int32"))
    params = {k: p.data().asnumpy()
              for k, p in jnet.collect_params().items()}
    if strong:
        params = strong_transformer_params(params, seed)
        for k, p in jnet.collect_params().items():
            p.set_data(mx.np.array(params[k]))
    tnet = TransformerModel(**cfg)
    load_jax_params(tnet, params)
    return jnet, tnet, params
